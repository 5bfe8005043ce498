"""Silent-data-corruption defence (``mxnet_tpu/integrity.py``): state
fingerprints, replica votes and verified rollback.

The NaN sentinel, the CRC manifests and the heartbeats catch failures
that announce themselves.  A flaky card that writes finite but wrong
numbers announces nothing; this module gives the fused trainer a cheap,
deterministic way to notice that two copies of the "same" state no
longer hold the same bits.

Fingerprint algorithm (``ALGO`` = ``"xmf1"``), the JAX package's bit for
bit:

* every leaf is read as 32-bit words (4-byte dtypes directly, any other
  dtype through its bytes, one word a byte), so the checksum is over
  bits: ``-0.0 != 0.0`` and every NaN payload counts;
* a leaf's fingerprint is ``sum(bits * (i * 2654435761 | 1)) mod 2**32``
  over the flattened word index ``i``: position-weighted, and made only
  of wrap-around integer sums, so it does not depend on the order of the
  sum or on how the leaf is split into pieces;
* the global fingerprint folds the per-leaf values with a CRC32 salt of
  each leaf's path, so leaves that swap contents cannot cancel.

On torch tensors each word (the int32 view of a 4-byte leaf, or a byte)
is multiplied by its weight, held in int64 below 2**32, so the product
is exact and congruent modulo 2**32 to the JAX package's uint32 product
(a word's sign does not change its residue); the products are masked to
their low 32 bits, summed in int64 (no overflow: a chunk holds at most
:data:`CHUNK` of them) and the sum masked again.  A leaf is taken in
chunks of :data:`CHUNK` words, which bounds the int64 temporaries
(GPT-2 small's token embedding alone is 38.6 M words).  The weights are
made once per device, as long as the longest leaf seen (:func:`reserve`
makes them before a CUDA graph captures a fingerprint).  The device work
is plain PyTorch ops with no host read, so a CUDA graph can hold it.
:func:`host_leaf_fingerprint` is the numpy mirror.

State-leaf paths are the JAX package's strings letter for letter:
``arg:NAME``, ``aux:NAME`` and ``opt:NAME`` followed by
``jax.tree_util.keystr`` of the leaf's place in that parameter's
optimizer state (``opt:fc1_weight[0]`` for Adam's mean, ``opt:fc1_weight``
for SGD's momentum); a ``None`` in a state holds no leaf.  The trainer's
wiring (the check graph, the vote, the audit replay) is in
``parallel/trainer.py``, the manifest's verification in
``resilience.py``.
"""
from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError

__all__ = ["ALGO", "IntegrityError", "leaf_fingerprint",
           "host_leaf_fingerprint", "fold_fingerprints", "path_salt",
           "named_state_leaves", "host_fingerprint", "manifest_record",
           "verify_manifest_record", "bitflip", "blame_minority",
           "match_leaf", "CHUNK", "reserve", "word_count"]

ALGO = "xmf1"

# Knuth's golden-ratio multiplicative constant; ``| 1`` keeps every
# weight odd (a unit mod 2**32: no word is ever multiplied by zero)
_MULT = 2654435761
_MASK = 0xFFFFFFFF

# words of a leaf taken at once on the device: each chunk makes an int64
# temporary of this many elements (32 MiB)
CHUNK = 1 << 22

# the weight of word i, ``(i * _MULT mod 2**32) | 1`` in int64, per
# device, for every i below the longest leaf seen; a grown table keeps
# the ones before it alive, since a captured graph reads the table it
# was captured with
_WEIGHTS: Dict[torch.device, torch.Tensor] = {}
_OUTGROWN: List[torch.Tensor] = []


class IntegrityError(MXNetError):
    """A state-integrity check failed: replicas disagree on bits that
    must be identical, or a deterministic replay produced a different
    fingerprint.  ``record`` carries the evidence::

        {"step": int,          # update counter at the failed check
         "mode": "vote"|"audit",
         "world": int,         # replicas voting (1 for audit)
         "fps": [[...], ...],  # per-replica fingerprint rows (vote)
         "leaves": [...],      # paths of the diverging leaves
         "blamed": [...]|None} # outvoted ranks (None: undetermined
                               # until the rollback replay resolves it)

    A subclass of MXNetError; a caller with a checkpoint line catches it
    first and rolls back to the newest verified checkpoint."""

    def __init__(self, message: str, record: Optional[dict] = None):
        super().__init__(message)
        self.record = record or {}
        # every IntegrityError made is a detected divergence
        from . import obs as _obs
        _obs.counter("integrity.divergences").inc()


# --------------------------------------------------------------- torch
def reserve(device, words: int) -> torch.Tensor:
    """The weights of the first ``words`` words on ``device`` (made, or
    grown to a whole number of chunks, when they are not there yet)."""
    device = torch.device(device)
    w = _WEIGHTS.get(device)
    if w is None or w.numel() < words:
        n = max(CHUNK, -(-int(words) // CHUNK) * CHUNK)
        if w is not None:
            _OUTGROWN.append(w)
        w = ((torch.arange(n, dtype=torch.int64, device=device) * _MULT)
             & _MASK) | 1
        _WEIGHTS[device] = w
    return w


def _words(x: torch.Tensor) -> torch.Tensor:
    """The leaf's flattened 32-bit words as a 1-d view (4-byte dtypes),
    or its bytes (any other dtype)."""
    x = x.detach().contiguous().reshape(-1)
    if x.element_size() == 4:
        return x.view(torch.int32)
    return x.view(torch.uint8)


def word_count(x: torch.Tensor) -> int:
    """The words :func:`leaf_fingerprint` reads of ``x``."""
    return max(1, x.numel()) * (1 if x.element_size() == 4
                                else x.element_size())


def leaf_fingerprint(x: torch.Tensor) -> torch.Tensor:
    """The fingerprint of one tensor: a 0-d int64 tensor on its device
    holding the uint32 value.  Chunked, with no host read (capturable in
    a CUDA graph once :func:`reserve` covers the leaf); equal to
    :func:`host_leaf_fingerprint` of the same values."""
    words = _words(x)
    n = words.numel()
    w = reserve(words.device, n)
    if n <= CHUNK:
        return (words * w[:n]).bitwise_and_(_MASK).sum() & _MASK
    total = None
    for start in range(0, n, CHUNK):
        end = min(n, start + CHUNK)
        part = (words[start:end] * w[start:end]).bitwise_and_(_MASK).sum()
        total = part if total is None else total + part
    return total & _MASK


def fold_fingerprints(fps: torch.Tensor, salts: torch.Tensor
                      ) -> torch.Tensor:
    """Fold per-leaf fingerprints (int64 holding uint32) with per-leaf
    salts into one global fingerprint (0-d int64): commutative, so leaf
    order never matters as long as the salts ride their leaves.  Each
    product is formed modulo 2**32 from the salt's 16-bit halves, so no
    int64 product overflows."""
    low = fps * (salts & 0xFFFF)
    high = ((fps * (salts >> 16)) & 0xFFFF) << 16
    return ((low + high) & _MASK).sum() & _MASK


# --------------------------------------------------------------- numpy
def host_leaf_fingerprint(arr) -> int:
    """Numpy mirror of :func:`leaf_fingerprint` (the JAX package's,
    wrap-around uint32 math): re-hashes loaded checkpoint artifacts
    against the device-computed manifest value."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.view(torch.int16)
        arr = arr.numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    if a.ndim == 0:
        a = a.reshape(1)
    if a.dtype == np.uint32:
        bits = a.reshape(-1)
    elif a.dtype.itemsize == 4:
        bits = a.reshape(-1).view(np.uint32)
    else:
        bits = a.reshape(-1).view(np.uint8).astype(np.uint32)
    with np.errstate(over="ignore"):
        idx = (np.arange(bits.size, dtype=np.uint32) * np.uint32(_MULT)) \
            | np.uint32(1)
        return int(np.sum(bits * idx, dtype=np.uint32))


def path_salt(path: str) -> int:
    """Odd uint32 salt for a leaf path (CRC32 of the path: stable
    across processes, unlike ``hash()``)."""
    return (zlib.crc32(path.encode("utf-8")) | 1) & _MASK


def _keyed_leaves(tree, key=""):
    """``(keystr, leaf)`` of a state tree in ``jax.tree_util`` order and
    spelling: a tuple or list element ``[i]``, a dict entry ``['k']`` in
    sorted key order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _keyed_leaves(tree[k], "%s[%r]" % (key, k))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, t in enumerate(tree):
            out += _keyed_leaves(t, "%s[%d]" % (key, i))
        return out
    return [(key, tree)]


def named_state_leaves(arg_params: Optional[Dict] = None,
                       aux_params: Optional[Dict] = None,
                       opt_state=None) -> List[Tuple[str, object]]:
    """The canonical ``(path, leaf)`` list of a training state:
    ``arg:NAME``, ``aux:NAME``, ``opt:NAME<keystr>``, in sorted-name
    order.  The trainer's device fingerprint, the manifest record and
    the load-time re-hash all walk this list."""
    out = []
    for name in sorted(arg_params or {}):
        out.append(("arg:%s" % name, arg_params[name]))
    for name in sorted(aux_params or {}):
        out.append(("aux:%s" % name, aux_params[name]))
    if opt_state:
        for name in sorted(opt_state):
            for key, leaf in _keyed_leaves(opt_state[name]):
                out.append(("opt:%s%s" % (name, key), leaf))
    return out


def host_fingerprint(named: Sequence[Tuple[str, object]]
                     ) -> Tuple[int, Dict[str, int]]:
    """``(global, {path: fp})`` over ``(path, host array)`` pairs: the
    numpy side of the device computation."""
    leaves = {}
    total = 0
    for path, value in named:
        fp = host_leaf_fingerprint(value)
        leaves[path] = fp
        total = (total + fp * path_salt(path)) & _MASK
    return total, leaves


# ------------------------------------------------------- manifest glue
def manifest_record(global_fp: int, leaves: Dict[str, int],
                    mode: str = "fp") -> dict:
    """The checkpoint manifest's ``integrity`` entry."""
    return {"algo": ALGO, "mode": mode, "global": int(global_fp),
            "leaves": {k: int(v) for k, v in leaves.items()}}


def verify_manifest_record(record: dict,
                           named: Sequence[Tuple[str, object]],
                           logger=None, what: str = "checkpoint"
                           ) -> bool:
    """Re-hash loaded artifacts against a manifest integrity record.  A
    divergence is reported by leaf; an unknown algo verifies vacuously
    (a later format must not brick every old reader); a ``refused``
    record (the saver declined to fingerprint a state its replicas
    disagreed on) never verifies."""
    from . import obs as _obs
    if not record:
        return True
    if record.get("refused"):
        if logger is not None:
            logger.warning(
                "%s recorded a REFUSED fingerprint (state diverged at "
                "save): %s", what, record["refused"])
        _obs.counter("integrity.verify_refused").inc()
        return False
    if record.get("algo") != ALGO:
        return True
    global_fp, leaves = host_fingerprint(named)
    if global_fp == record.get("global"):
        return True
    if logger is not None:
        want = record.get("leaves", {})
        bad = sorted(p for p, fp in leaves.items()
                     if want.get(p) is not None and want[p] != fp)
        missing = sorted(set(want) - set(leaves))
        logger.warning(
            "%s fails fingerprint verification (global %08x vs manifest "
            "%08x): diverging leaves %s%s; the values changed after the "
            "manifest was committed", what, global_fp,
            record.get("global") or 0, bad or "<global-only>",
            (", missing %s" % missing) if missing else "")
    _obs.counter("integrity.verify_failed").inc()
    return False


# ------------------------------------------------------------ bitflip
def bitflip(value: torch.Tensor, rank: int, bit: int = 12,
            my_rank: Optional[int] = None) -> torch.Tensor:
    """XOR-flip one bit of ``value``'s first element, in place, on the
    copy held by replica ``rank`` of the data axis: with ``my_rank``
    (this process's index on the axis) only the process holding that
    copy flips, and the others keep their bits, so the leaf stays
    claimed replicated while its copies differ, which is what a corrupt
    card makes.  Without ``my_rank`` (one copy) the flip always lands.

    Float32 leaves only; ``bit`` 0-22 lands in the mantissa, a finite
    and quiet corruption the NaN sentinel never sees."""
    if value.dtype != torch.float32:
        raise MXNetError("bitflip targets f32 state leaves, got %s"
                         % (value.dtype,))
    if not 0 <= int(bit) <= 31:
        raise MXNetError("bitflip bit=%r out of range 0-31" % (bit,))
    if my_rank is not None and int(my_rank) != int(rank):
        return value
    # the mask as a signed int32 (bit 31 is the sign bit)
    mask = (1 << int(bit)) - (1 << 32 if int(bit) == 31 else 0)
    with torch.no_grad():
        words = value.view(torch.int32).view(-1)
        words[0:1].bitwise_xor_(mask)
    return value


def match_leaf(pattern: str, paths: Sequence[str]) -> Optional[str]:
    """First state-leaf path matching a ``leaf=`` glob.

    Only ``*`` and ``?`` are wildcards: ``[``/``]`` are literal, so
    ``opt:fc1_weight[0]`` is addressable.  ``/`` spells the namespace
    colon (``leaf=opt/fc1_weight[0]``), since ``:`` separates conditions
    in the fault grammar; the bare name after the namespace is also
    tried (``leaf=fc1*``)."""
    rx = re.compile("".join(
        ".*" if ch == "*" else "." if ch == "?" else re.escape(ch)
        for ch in pattern.replace("/", ":")))
    for path in paths:
        bare = path.split(":", 1)[-1]
        if rx.fullmatch(path) or rx.fullmatch(bare):
            return path
    return None


# ---------------------------------------------------------------- vote
def blame_minority(matrix: np.ndarray, rep_cols: Sequence[int]
                   ) -> Tuple[bool, Optional[List[int]], List[int]]:
    """Majority vote over per-replica fingerprint rows.

    ``matrix`` is ``(n_replicas, n_leaves)``; only ``rep_cols`` (the
    replicated leaves: ZeRO-1 shards legitimately differ) vote.  Returns
    ``(agree, blamed, diverging_cols)``: ``blamed`` is the strict
    minority when a strict majority of replicas agree on every voting
    column, else ``None`` (a 1-vs-1 split carries no evidence of which
    copy is right; the rollback replay resolves it)."""
    mat = np.asarray(matrix)
    n = mat.shape[0]
    cols = list(rep_cols)
    sub = mat[:, cols] if cols else mat[:, :0]
    agree = bool((sub == sub[0:1]).all()) if n > 1 else True
    if agree:
        return True, None, []
    diverging = [cols[j] for j in range(sub.shape[1])
                 if not (sub[:, j] == sub[0, j]).all()]
    groups: Dict[bytes, List[int]] = {}
    for r in range(n):
        groups.setdefault(sub[r].tobytes(), []).append(r)
    best = max(groups.values(), key=len)
    if len(best) * 2 > n:
        blamed = sorted(r for r in range(n) if r not in best)
        return False, blamed, diverging
    return False, None, diverging
