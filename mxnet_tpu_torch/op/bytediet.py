"""Byte-diet backward formulations (``mxnet_tpu/op/bytediet.py``).

The JAX package rewrites the backward of three ops of the fused ResNet
step so that it reads fewer activation-sized operands.  Their numerics
are what the port reproduces:

* **ReLU** (``relu_save_output``): the mask comes from the output,
  ``dx = where(y > 0, dy, 0)``, so the subgradient at 0 is 0.
  ``torch.relu``'s autograd saves its result and masks on ``result > 0``:
  the same formulation, so ``Activation(relu)`` stays ``torch.relu``
  (``tests/test_torch_conv_pool_bn.py`` pins it bitwise).
* **MaxPool** (``max_pool_argmax``): the forward keeps the index of the
  first (smallest linear index) maximum of each window, and the backward
  scatter-adds the cotangent at the saved indices; a window that lies
  wholly in the padding drops its cotangent.  PyTorch's max pooling
  keeps the first maximum of its row-major window scan, saves that index
  map for its backward and accumulates there; the Pooling op pads the
  input itself where a window may lie in the padding, so such a
  window's cotangent lands in the padding and is cut away with it.  The
  Pooling op is that formulation under either policy (tests pin it
  bitwise in float32).
* **BatchNorm** (:func:`bn_batch_stats`, :func:`bn_train_normalize`):
  single-pass float32 statistics centred on the running mean, with an
  exact two-pass fallback when they would cancel, and the closed-form
  backward ``dx = x*A + dy*S + B`` with per-channel float32 ``A``, ``S``,
  ``B`` and float32-accumulated ``dgamma`` and ``dbeta``.  These differ
  from torch's autograd and are written out here.

``MXTPU_DTYPE_POLICY`` (or ``Trainer(dtype_policy=...)``) picks
``"bytediet"`` (the default) or ``"legacy"``, under which BatchNorm's
backward is autograd through its plain ``rsqrt`` expression, as in the
JAX package; an unknown value raises.
"""
from __future__ import annotations

import math
import os

import torch

__all__ = ["enabled", "default_policy", "bn_batch_stats",
           "bn_train_normalize"]


def default_policy():
    """The process-wide default policy (``MXTPU_DTYPE_POLICY``)."""
    return os.environ.get("MXTPU_DTYPE_POLICY", "bytediet")


def enabled(ctx):
    """True when the op context (or the process default) selects the
    byte-diet formulations.  An unknown policy raises: a misspelt A/B
    knob must not run the formulations it was meant to turn off."""
    pol = getattr(ctx, "dtype_policy", None) or default_policy()
    if pol not in ("bytediet", "legacy"):
        raise ValueError("unknown dtype_policy %r (bytediet|legacy)"
                         % (pol,))
    return pol != "legacy"


def _bshape(data, ax):
    return tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))


# ----------------------------------------------------------------------
# BatchNorm.  Cancellation guard: the shifted-moment variance
# E[(x-c)^2] - E[x-c]^2, centred on the running mean c, cancels when the
# batch mean sits far from c (the first steps after init, a shift in the
# data).  When d1^2 > (63/64) d2 for any channel the exact two-pass
# statistics are taken instead.  The JAX package branches with lax.cond;
# here both variances are computed and torch.where picks on the device,
# so the choice needs no host read and a CUDA graph can capture it.
_CANCEL_FRAC = 63.0 / 64.0


def bn_batch_stats(data, center32, reduce_axes, batch_sum=None, ranks=1):
    """Float32 batch statistics of ``data`` over ``reduce_axes``, centred
    on the per-channel float32 ``center32``, with the cancellation
    fallback.  Returns ``(mean32, var32)`` per channel.  With
    ``batch_sum`` (the batch's rows on ``ranks`` ranks of a data mesh)
    each sum is summed over the ranks, so the statistics are the whole
    batch's on every rank."""
    dims = tuple(reduce_axes)
    ax = [i for i in range(data.ndim) if i not in dims]
    assert len(ax) == 1
    bshape = _bshape(data, ax[0])
    n_red = float(math.prod(data.shape[i] for i in dims)) * ranks
    # data - center32 widens a bfloat16 or float16 input to float32
    # exactly, in the same pass as the subtraction
    xc = data - center32.reshape(bshape)
    s1, s2 = xc.sum(dims), (xc * xc).sum(dims)
    if batch_sum is not None:
        s1, s2 = batch_sum(torch.stack([s1, s2]))
    d1 = s1 / n_red
    d2 = s2 / n_red
    mean32 = d1 + center32
    fast = torch.clamp_min(d2 - d1 * d1, 0.0)
    xm = data - mean32.reshape(bshape)
    sm = (xm * xm).sum(dims)
    if batch_sum is not None:
        sm = batch_sum(sm)
    two_pass = sm / n_red
    cancels = (d1 * d1 > _CANCEL_FRAC * d2).any()
    return mean32, torch.where(cancels, two_pass, fast)


class _BNTrainNormalize(torch.autograd.Function):
    """Train-mode BatchNorm apply with the closed-form backward: the port
    of ``bn_train_normalize`` (``_bn_fwd``, ``_bn_bwd``).  The batch
    statistics come in computed (by :func:`bn_batch_stats`, whose results
    also feed the moving averages), and carry no gradient: the closed
    form accounts for them."""

    @staticmethod
    def forward(ctx, data, gamma, beta, mean32, var32, ax, eps, batch_sum,
                ranks):
        bshape = _bshape(data, ax)
        inv32 = torch.rsqrt(var32 + eps)
        scale32 = gamma.float() * inv32
        shift32 = beta.float() - mean32 * scale32
        out = data * scale32.reshape(bshape).to(data.dtype) \
            + shift32.reshape(bshape).to(data.dtype)
        # the input (alive anyway) and per-channel vectors: no
        # activation-sized temporary survives to the backward
        ctx.save_for_backward(data, mean32, inv32, scale32)
        ctx.ax = ax
        ctx.dtypes = (gamma.dtype, beta.dtype)
        ctx.batch = (batch_sum, ranks)
        return out

    @staticmethod
    def backward(ctx, dy):
        data, mean32, inv32, scale32 = ctx.saved_tensors
        ax = ctx.ax
        bshape = _bshape(data, ax)
        dims = tuple(i for i in range(data.ndim) if i != ax)
        batch_sum, ranks = ctx.batch
        n_red = float(math.prod(data.shape[i] for i in dims)) * ranks
        dt = data.dtype
        # per-channel sums accumulate in float32 over products in the
        # cotangent's dtype
        dbeta32 = dy.sum(dims, dtype=torch.float32)
        xhat = (data - mean32.reshape(bshape).to(dt)) \
            * inv32.reshape(bshape).to(dt)
        dgamma32 = (dy * xhat).sum(dims, dtype=torch.float32)
        # over a data mesh dx reads the whole batch's sums; dgamma and
        # dbeta stay this rank's (the step sums the gradients)
        gbeta32, ggamma32 = (dbeta32, dgamma32) if batch_sum is None \
            else batch_sum(torch.stack([dbeta32, dgamma32]))
        # dx = (gamma*inv)(dy - sum(dy)/n - xhat*sum(dy*xhat)/n), as
        # dx = x*A + dy*S + B with per-channel float32 A, S, B
        c2 = ggamma32 / n_red * inv32
        a = -scale32 * c2
        b = scale32 * (mean32 * c2 - gbeta32 / n_red)
        dx = data * a.reshape(bshape).to(dt) \
            + dy * scale32.reshape(bshape).to(dy.dtype) \
            + b.reshape(bshape).to(dt)
        gdt, bdt = ctx.dtypes
        return (dx.to(dt), dgamma32.to(gdt), dbeta32.to(bdt),
                None, None, None, None, None, None)


def bn_train_normalize(data, gamma, beta, mean32, var32, ax, eps,
                       batch_sum=None, ranks=1):
    """``data * scale + shift`` with per-channel float32 ``scale =
    gamma * rsqrt(var32 + eps)`` and ``shift = beta - mean32 * scale``
    rounded to the data's dtype, differentiated in closed form (over
    the whole batch of a data mesh with ``batch_sum``, as
    :func:`bn_batch_stats`)."""
    return _BNTrainNormalize.apply(data, gamma, beta, mean32.detach(),
                                   var32.detach(), ax, eps, batch_sum,
                                   ranks)
