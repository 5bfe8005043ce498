"""Collectives over the worker processes
(``mxnet_tpu/parallel/collectives.py``).

The JAX package joins ``jax.distributed`` and sums with XLA collectives
inside its compiled step.  The port joins ``torch.distributed``
(:func:`join_from_env`, called when the package is imported with the
launcher's ``MXTPU_*`` variables) and sums with its collectives.

The backend is fixed when the group is made, from every rank's host and
card count: NCCL where each rank has a card of its own (``cuda:(i %
device_count)``, ``i`` the rank's index on its host: its rank on one
host), gloo on the CPU, and gloo where ranks share one card (NCCL
refuses two ranks on one device).
A backend that fails to start raises; it never gives way to another.
Over gloo a CUDA tensor is staged through the host (the collective runs
on a CPU copy, and the result is copied back), over NCCL a host tensor
through the rank's card.  Over NCCL a sum is issued
as ``PREMUL_SUM`` with a factor of 1.0: bitwise the plain sum, and at
one rank NCCL still launches a kernel for it (a plain sum over one rank
is a copy or nothing), so a one-card run captures a real collective.
"""
from __future__ import annotations

import datetime
import os
import socket
import time

import numpy as np
import torch

from .. import base as _base

__all__ = ["global_allreduce", "barrier", "psum_over_mesh",
           "broadcast_from_rank0", "lowp_allreduce", "lowp_comm_bytes",
           "collective_wire_bytes", "join_from_env", "backend",
           "all_reduce_", "reduce_scatter", "all_gather", "all_to_all",
           "sum_over_ranks", "host_comm_seconds"]


def _dist():
    d = torch.distributed
    return d if d.is_available() and d.is_initialized() else None


def _process_count():
    d = _dist()
    return d.get_world_size() if d is not None else 1


def _process_index():
    d = _dist()
    return d.get_rank() if d is not None else 0


def backend():
    """The process group's backend (``"nccl"``/``"gloo"``), or None."""
    d = _dist()
    return d.get_backend() if d is not None else None


def _choose_backend(layout, rank):
    """The backend and this rank's device from every rank's ``(host,
    cards on that host)``, in rank order.  A rank's card is
    ``cuda:(i % cards)``, ``i`` its index among the ranks of its host
    (its rank, on one host).  NCCL where each rank has a card of its
    own: every rank sees a card, and no host holds more ranks than
    cards; else gloo (on the CPU, or ranks sharing a card)."""
    host, cards = layout[rank]
    local = [r for r, (h, _) in enumerate(layout) if h == host]
    device = torch.device("cuda", local.index(rank) % cards) if cards \
        else None
    on_host = {}
    for h, c in layout:
        on_host.setdefault(h, [0, c])[0] += 1
    own = all(c > 0 and n <= c for n, c in on_host.values())
    return ("nccl" if own else "gloo"), device


def _host_layout(store, world, rank):
    """Every rank's ``(host name, CUDA cards it sees)``, through the
    store the ranks meet at."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    store.set("mxtpu/layout/%d" % rank, "%d %s" % (cards,
                                                   socket.gethostname()))
    layout = []
    for r in range(world):
        count, host = store.get("mxtpu/layout/%d" % r).decode().split(" ", 1)
        layout.append((host, int(count)))
    return layout


def _meet(coordinator, world, rank, timeout, attempts):
    """The TCP store at the coordinator (rank 0 serves it), with up to
    ``attempts`` attempts (backoff from 0.5 s)."""
    host, port = coordinator.rsplit(":", 1)
    delay = 0.5
    for attempt in range(attempts):
        try:
            return torch.distributed.TCPStore(
                host, int(port), world, rank == 0, timeout=timeout)
        except Exception:          # noqa: BLE001 - re-raised at the end
            if attempt + 1 >= attempts:
                raise
            time.sleep(delay)
            delay *= 2.0


def join_from_env():
    """Join the process group the launcher describes
    (``tools/launch.py``: ``MXTPU_COORDINATOR`` = ``host:port`` of rank
    0, ``MXTPU_NUM_PROCESSES``, ``MXTPU_PROCESS_ID``), with up to
    ``MXTPU_INIT_ATTEMPTS`` attempts of at most ``MXTPU_INIT_TIMEOUT_S``
    seconds each to meet at the coordinator's store.  The ranks swap
    their hosts and card counts there, which fixes the backend
    (:func:`_choose_backend`).  A rank's device becomes the default
    ``gpu`` context."""
    env = os.environ
    missing = [v for v in ("MXTPU_NUM_PROCESSES", "MXTPU_PROCESS_ID")
               if v not in env]
    if missing:
        raise RuntimeError(
            "MXTPU_COORDINATOR is set but %s %s missing — the launcher "
            "contract (tools/launch.py) requires all three MXTPU_* vars"
            % (" and ".join(missing), "is" if len(missing) == 1 else "are"))
    dist = torch.distributed
    if dist.is_initialized():
        return
    world = int(env["MXTPU_NUM_PROCESSES"])
    rank = int(env["MXTPU_PROCESS_ID"])
    seconds = float(env.get("MXTPU_INIT_TIMEOUT_S", "0") or 0)
    timeout = datetime.timedelta(seconds=seconds) if seconds > 0 \
        else dist.default_pg_timeout
    store = _meet(env["MXTPU_COORDINATOR"], world, rank, timeout,
                  max(1, int(env.get("MXTPU_INIT_ATTEMPTS", "3"))))
    name, device = _choose_backend(_host_layout(store, world, rank), rank)
    if device is not None:
        torch.cuda.set_device(device)
        _base.set_default_gpu(device.index)
    kw = {}
    if name == "nccl":
        # the communicator is made now, bound to the rank's card
        kw["device_id"] = device
    dist.init_process_group(name, store=store, world_size=world, rank=rank,
                            timeout=timeout, **kw)


# ----------------------------------------------------------------------
# the collectives the store and the fused step issue


# host seconds of the collectives staged from a card through the host
# (gloo), each timed between two synchronisations of the card
_HOST_COMM_S = [0.0]


def host_comm_seconds():
    """The seconds this process has spent in collectives on CUDA tensors
    staged through the host (gloo): their copies, the collective and the
    copies back, each timed from a synchronised card to a synchronised
    card."""
    return _HOST_COMM_S[0]


def _staged(fn, *tensors):
    """Run ``fn`` on the tensors where the backend moves them: through
    host copies when gloo is asked to move CUDA tensors (timed into
    :func:`host_comm_seconds`), through copies on this rank's card when
    NCCL is asked to move host tensors; the results are written back in
    place."""
    name = backend()
    if name == "gloo" and any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = [t.cpu() for t in tensors]
        fn(*staged)
        for t, h in zip(tensors, staged):
            t.copy_(h)
        torch.cuda.synchronize()
        _HOST_COMM_S[0] += time.perf_counter() - t0
        return
    if name == "nccl" and any(not t.is_cuda for t in tensors):
        dev = torch.device("cuda", torch.cuda.current_device())
        staged = [t.to(dev) for t in tensors]
    else:
        fn(*tensors)
        return
    fn(*staged)
    for t, h in zip(tensors, staged):
        t.copy_(h)


def _sum_op():
    dist = torch.distributed
    if backend() == "nccl":
        return dist._make_nccl_premul_sum(1.0)
    return dist.ReduceOp.SUM


def all_reduce_(x):
    """Sum ``x`` over every rank, in place."""
    dist = torch.distributed
    _staged(lambda t: dist.all_reduce(t, op=_sum_op()), x)
    return x


def reduce_scatter(x, n):
    """Rank r's rows ``[r*m, (r+1)*m)`` of the sum over ranks of ``x``
    (dim 0 of size ``n*m``)."""
    dist = torch.distributed
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _staged(lambda o, i: dist.reduce_scatter_tensor(o, i, op=_sum_op()),
              out, x.contiguous())
    return out


def all_gather(x, n):
    """Every rank's ``x`` stacked along dim 0, rank-major."""
    dist = torch.distributed
    out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
    _staged(dist.all_gather_into_tensor, out, x.contiguous())
    return out


def all_to_all(x):
    """Chunk j of dim 0 goes to rank j; the result holds every rank's
    chunk of this rank, rank-major."""
    dist = torch.distributed
    out = torch.empty_like(x)
    _staged(dist.all_to_all_single, out, x.contiguous())
    return out


def broadcast_from_rank0(value):
    """Every process returns process 0's ``value`` (the reference's
    rank-0-only init push + pull, ``kvstore_dist.h:63-80``)."""
    if _process_count() <= 1:
        return value
    out = value.detach().clone().contiguous()
    _staged(lambda t: torch.distributed.broadcast(t, 0), out)
    return out


def global_allreduce(value):
    """The sum of ``value`` over every process, a new tensor (the
    out-of-step counterpart of ``KVStoreDist::Push_``; the fused step
    sums inside itself)."""
    if _process_count() <= 1:
        return value
    return all_reduce_(value.detach().clone().contiguous())


class _SumOverRanks(torch.autograd.Function):
    """The sum over every rank, whose backward sums the cotangent over
    every rank (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.detach().contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


def sum_over_ranks(x):
    """The sum of ``x`` over every rank, a new tensor, differentiable:
    how BatchNorm's statistics cover the whole batch of a data mesh."""
    return _SumOverRanks.apply(x)


def psum_over_mesh(x, axis_name="data"):
    """The in-step sum over the mesh's ``data`` axis (every rank)."""
    return all_reduce_(x)


def lowp_allreduce(x, axis_name, n, comm_dtype, keep_shard=False):
    """The gradient sum with a narrow wire and a float32 accumulator.

    1. reduce-scatter: round ``x`` to ``comm_dtype`` and all-to-all its
       dim-0 chunks, so rank i holds every rank's chunk i; sum the ``n``
       contributions in float32, in rank order.
    2. all-gather the reduced chunk, rounded to ``comm_dtype`` again —
       unless ``keep_shard`` (ZeRO-1), where the float32 chunk feeds the
       sharded update directly.

    A leaf whose dim 0 does not divide by ``n`` takes an all-gather of
    the narrow leaf and a float32 sum in rank order (its "shard" under
    ``keep_shard`` is the whole leaf).  Each element is rounded at most
    twice, so the sum carries about 2^-8 relative error."""
    g16 = x.to(comm_dtype)
    d0 = x.shape[0] if x.dim() else 0
    if x.dim() and d0 >= n and d0 % n == 0:
        parts = all_to_all(g16).reshape((n, d0 // n) + tuple(x.shape[1:]))
        summed = parts[0].float()
        for i in range(1, n):
            summed = summed + parts[i].float()
        if keep_shard:
            return summed
        return all_gather(summed.to(comm_dtype), n).float()
    parts = all_gather(g16.reshape((1,) + tuple(x.shape)), n)
    out = parts[0].float()
    for i in range(1, n):
        out = out + parts[i].float()
    return out


def lowp_comm_bytes(shape, n, comm_itemsize=2, keep_shard=False):
    """Per-replica wire bytes :func:`lowp_allreduce` moves for one leaf."""
    size = int(np.prod(shape or (1,)))
    d0 = shape[0] if shape else 0
    if d0 >= n and d0 % n == 0:
        rs = (n - 1) / n * size * comm_itemsize
        ag = 0 if keep_shard else (n - 1) / n * size * comm_itemsize
        return rs + ag
    return (n - 1) * size * comm_itemsize


def collective_wire_bytes(primitive: str, elements: int, itemsize: int,
                          n: int) -> int:
    """Predicted per-replica wire bytes of one collective on an operand
    of ``elements`` items of ``itemsize`` bytes over ``n`` replicas, by
    the ring model: all-reduce ``2(n-1)/n |x|``, reduce-scatter and
    all-to-all ``(n-1)/n |x|``, all-gather ``(n-1)|x|`` (the operand is
    the local shard), a permute ``|x|``; 0 for anything else."""
    if n <= 1:
        return 0
    size = int(elements) * int(itemsize)
    if primitive in ("psum", "pmean", "pmax", "pmin", "psum2",
                     "all_reduce"):
        return int(2 * (n - 1) / n * size)
    if primitive in ("reduce_scatter", "psum_scatter"):
        return int((n - 1) / n * size)
    if primitive == "all_gather":
        return int((n - 1) * size)
    if primitive == "all_to_all":
        return int((n - 1) / n * size)
    if primitive == "ppermute":
        return size
    return 0


def barrier():
    """Every process meets here (``ps::Postoffice::Barrier``)."""
    if _process_count() > 1:
        if backend() == "nccl":
            torch.distributed.barrier(
                device_ids=[torch.cuda.current_device()])
        else:
            torch.distributed.barrier()
