"""Connectionist Temporal Classification loss, the ``WarpCTC`` op
(``mxnet_tpu/op/ctc.py``; reference ``plugin/warpctc/warpctc-inl.h``).

- ``data``: ``(seq_len * batch, vocab)`` activations, time-major; class
  0 is the blank.
- ``label``: ``(batch, label_length)`` int-valued floats, 0-padded; the
  0 entries are removed, so real symbols are 1-based and a row's label
  length is its count of non-zero entries.
- The forward is ``softmax(data)``.
- The backward injects the CTC gradient ``softmax - gamma``, ``gamma``
  the per-frame symbol posterior of the log-space alpha-beta recursion
  (a loop over the frames, every sequence of the batch at once, masked
  to each label's length), whatever the head gradient.  A label that
  needs more frames than it has gets a zero gradient, as warp-ctc gives.

The JAX package's recursion, in PyTorch ops; the posterior is summed per
symbol by a product with the one-hot label sequence, not by a scatter,
so the CUDA result does not depend on the order of atomic adds.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import Param, _REGISTRY, register

_NEG_INF = -1e30


def _compact_labels(label):
    """Remove 0 (blank/pad) entries, keeping order: (the compacted int64
    ``(B, L)`` labels padded with 0, the lengths ``(B,)``)."""
    lab = label.detach().to(torch.int64)
    nonblank = lab != 0
    # a stable sort of "is blank" moves the real symbols to the front
    order = torch.argsort((~nonblank).to(torch.int8), dim=1, stable=True)
    return lab.gather(1, order), nonblank.sum(dim=1)


def _logaddexp3(a, b, c):
    return torch.logaddexp(torch.logaddexp(a, b), c)


def _ctc_alpha_beta(logp, compact, lengths):
    """Log-space alpha and beta over the extended label sequence.

    logp: (T, B, V) log-softmax; compact: (B, L) 1-based symbols;
    lengths: (B,).  Returns (negative log-likelihood (B,), gamma
    (T, B, V))."""
    T, B, V = logp.shape
    L = compact.shape[1]
    S = 2 * L + 1
    dev = logp.device
    # the extended sequence: blanks at even s, symbols at odd s
    z = torch.zeros(B, S, dtype=torch.int64, device=dev)
    z[:, 1::2] = compact
    s_idx = torch.arange(S, device=dev)
    valid = s_idx[None] < (2 * lengths[:, None] + 1)          # (B,S)
    # a skip s-2 -> s is allowed at an odd s whose symbol differs from
    # the previous symbol
    z_prev2 = F.pad(z[:, :-2], (2, 0))
    can_skip = (s_idx[None] % 2 == 1) & (z != z_prev2)        # (B,S)
    can_skip_fwd = F.pad(can_skip[:, 2:], (0, 2))
    neg = torch.full((), _NEG_INF, dtype=logp.dtype, device=dev)
    emits = logp.gather(2, z[None].expand(T, B, S))           # (T,B,S)

    def shifted(a, k):
        return F.pad(a[:, :S - k], (k, 0), value=_NEG_INF)

    def shifted_fwd(a, k):
        return F.pad(a[:, k:], (0, k), value=_NEG_INF)

    # ---- alpha ----
    a = torch.full((B, S), _NEG_INF, dtype=logp.dtype, device=dev)
    a[:, 0] = emits[0, :, 0]
    a[:, 1] = torch.where(lengths > 0, emits[0, :, 1], neg)
    alphas = [a]
    for t in range(1, T):
        step2 = torch.where(can_skip, shifted(a, 2), neg)
        a = _logaddexp3(a, shifted(a, 1), step2) + emits[t]
        a = torch.where(valid, a, neg)
        alphas.append(a)
    alphas = torch.stack(alphas)                               # (T,B,S)

    last = 2 * lengths                                         # blank end
    aT = alphas[-1]
    end1 = aT.gather(1, last[:, None])[:, 0]
    end2 = torch.where(
        lengths > 0,
        aT.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0], neg)
    log_lik = torch.logaddexp(end1, end2)                      # (B,)

    # ---- beta (the reverse recursion) ----
    b = torch.full((B, S), _NEG_INF, dtype=logp.dtype, device=dev)
    b = torch.where(s_idx[None] == last[:, None], 0.0, b)
    b = torch.where((s_idx[None] == (last - 1)[:, None])
                    & (lengths[:, None] > 0), 0.0, b)
    betas = [b]
    for t in range(T - 1, 0, -1):
        # beta_t(s) = logsum over s' in {s, s+1, s+2} of
        #             beta_{t+1}(s') + emit_{t+1}(s')
        e = emits[t] + b
        step2 = torch.where(can_skip_fwd, shifted_fwd(e, 2), neg)
        b = torch.where(valid, _logaddexp3(e, shifted_fwd(e, 1), step2), neg)
        betas.append(b)
    betas = torch.stack(betas[::-1])                           # (T,B,S)

    # an infeasible label (more frames needed than the input has) has no
    # alignment: its log-likelihood stays at the sentinel; its rows'
    # gamma is zeroed and its loss is infinite
    feasible = log_lik > _NEG_INF / 2                          # (B,)
    post = alphas + betas - log_lik[None, :, None]
    post = torch.where(valid[None] & feasible[None, :, None], post, neg)
    onehot = F.one_hot(z, V).to(logp.dtype)                    # (B,S,V)
    gamma = torch.einsum("tbs,bsv->tbv", torch.exp(post), onehot)
    nll = torch.where(feasible, -log_lik,
                      torch.full((), float("inf"), dtype=logp.dtype,
                                 device=dev))
    return nll, gamma


def _log_probs(data, input_length):
    TB, V = data.shape
    T = input_length
    return F.log_softmax(data.reshape(T, TB // T, V).float(), dim=-1)


def _ctc_grad(data, label, input_length):
    logp = _log_probs(data, input_length)
    compact, lengths = _compact_labels(label)
    nll, gamma = _ctc_alpha_beta(logp, compact, lengths)
    grad = torch.exp(logp) - gamma                             # (T,B,V)
    # infeasible rows get a ZERO gradient, the warp-ctc behaviour
    grad = torch.where(torch.isfinite(nll)[None, :, None], grad, 0.0)
    return grad.reshape(data.shape).to(data.dtype)


def ctc_loss_value(data, label, input_length):
    """Per-sequence negative log-likelihood, shape ``(batch,)``; ``inf``
    for a label infeasible at this input_length."""
    logp = _log_probs(data, input_length)
    compact, lengths = _compact_labels(label)
    return _ctc_alpha_beta(logp, compact, lengths)[0]


class _WarpCTC(torch.autograd.Function):
    """softmax forward, the CTC gradient backward."""

    @staticmethod
    def forward(ctx, input_length, data, label):
        ctx.input_length = input_length
        ctx.save_for_backward(data, label)
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        grad = _ctc_grad(data, label, ctx.input_length)
        return None, grad, torch.zeros_like(label) \
            if ctx.needs_input_grad[2] else None


@register("WarpCTC",
          params_spec=(Param("label_length", int, 0),
                       Param("input_length", int, 0)),
          input_names=("data", "label"), hint="warpctc")
def _warpctc(p, c, data, label):
    return _WarpCTC.apply(p["input_length"], data, label)


def _warpctc_infer_shape(p, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        return None
    batch = dshape[0] // max(1, p["input_length"])
    lshape = (batch, p["label_length"])
    return [tuple(dshape), lshape], [tuple(dshape)], []


_REGISTRY["WarpCTC"].infer_shape = _warpctc_infer_shape


def ctc_greedy_decode(probs, seq_len, blank=0):
    """Collapse-repeats-then-drop-blanks greedy decoding of a
    ``(T*B, V)`` softmax output (host-side helper, numpy)."""
    probs = probs.asnumpy() if hasattr(probs, "asnumpy") \
        else np.asarray(probs)
    TB, V = probs.shape
    B = TB // seq_len
    best = probs.reshape(seq_len, B, V).argmax(-1)            # (T, B)
    out = []
    for b in range(B):
        seq, prev = [], -1
        for t in range(seq_len):
            k = int(best[t, b])
            if k != prev and k != blank:
                seq.append(k)
            prev = k
        out.append(seq)
    return out
