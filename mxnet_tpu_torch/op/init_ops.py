"""Creation and sampling ops (``mxnet_tpu/op/init_ops.py``).

An op without tensor inputs creates its output on ``OpContext.device``:
the executor's device, or the imperative call's ``ctx`` (else the current
context).  Samplers draw from ``OpContext.rng``, that device's
``torch.Generator`` (``random.py``): deterministic per seed, but other
numbers than the JAX package's threefry keys give.
"""
from __future__ import annotations

import math

import torch

from .registry import Param, register, alias


def _creation_spec():
    return (Param("shape", "shape", required=True),
            Param("ctx", str, None),
            Param("dtype", "dtype", torch.float32))


def _concrete(shape):
    """MXNet shape semantics: dim 0 = unknown.  Creation ops materialize
    unknown dims as broadcastable size-1 (an RNN's ``begin_state`` zeros
    of shape ``(0, h)`` meet real activations by broadcasting)."""
    return tuple(1 if d == 0 else d for d in shape)


register("_zeros", lambda p, c: torch.zeros(_concrete(p["shape"]),
                                            dtype=p["dtype"], device=c.device),
         params_spec=_creation_spec(), input_names=())
register("_ones", lambda p, c: torch.ones(_concrete(p["shape"]),
                                          dtype=p["dtype"], device=c.device),
         params_spec=_creation_spec(), input_names=())
register("_full", lambda p, c: torch.full(_concrete(p["shape"]), p["value"],
                                          dtype=p["dtype"], device=c.device),
         params_spec=_creation_spec() + (Param("value", float,
                                               required=True),),
         input_names=())
alias("zeros", "_zeros")
alias("ones", "_ones")
alias("full", "_full")


@register("_arange", params_spec=(
    Param("start", float, 0.0),
    Param("stop", lambda v: None if v in (None, "None") else float(v), None),
    Param("step", float, 1.0),
    Param("repeat", int, 1),
    Param("ctx", str, None),
    Param("dtype", "dtype", torch.float32)),
    input_names=())
def _arange_op(p, c):
    start, stop = p["start"], p["stop"]
    if stop is None:            # arange(n) == arange(0, n), as numpy reads it
        start, stop = 0.0, start
    vals = torch.arange(start, stop, p["step"], dtype=torch.float64,
                        device=c.device).to(p["dtype"])
    if p["repeat"] != 1:
        vals = vals.repeat_interleave(p["repeat"])
    return vals


# ----------------------------------------------------------------------
def _sample_spec(*extra):
    return extra + (Param("shape", "shape", ()),
                    Param("ctx", str, None),
                    Param("dtype", "dtype", torch.float32))


def _reg_sampler(name, spec, fn, aliases=()):
    register(name, fn, params_spec=_sample_spec(*spec), input_names=(),
             uses_rng=True)
    for al in aliases:
        alias(al, name)


def _empty(p, c):
    return torch.empty(p["shape"] or (1,), dtype=p["dtype"], device=c.device)


_reg_sampler(
    "_sample_uniform", (Param("low", float, 0.0), Param("high", float, 1.0)),
    lambda p, c: _empty(p, c).uniform_(p["low"], p["high"], generator=c.rng),
    aliases=("uniform", "random_uniform", "_random_uniform"))

_reg_sampler(
    "_sample_normal", (Param("loc", float, 0.0), Param("scale", float, 1.0)),
    lambda p, c: _empty(p, c).normal_(p["loc"], p["scale"], generator=c.rng),
    aliases=("normal", "random_normal", "_random_normal"))


def _standard_gamma(alpha, shape, gen, device):
    """Gamma(alpha, 1) draws in float32 from ``gen`` alone (torch's own
    gamma sampler takes no generator): Marsaglia and Tsang's squeeze for
    ``alpha >= 1``, every pending element drawing a normal and a uniform
    a round until all are accepted; for ``alpha < 1`` a Gamma(alpha + 1)
    draw times ``U ** (1 / alpha)``."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if device.type == "meta":
        return out
    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    flat = out.view(-1)
    pending = torch.arange(flat.numel(), device=device)
    while pending.numel():
        x = torch.empty(pending.numel(), device=device).normal_(
            generator=gen)
        u = torch.empty(pending.numel(), device=device).uniform_(
            generator=gen)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d
                        - d * v + d * torch.log(v.clamp(min=1e-30)))
        flat[pending[ok]] = d * v[ok]
        pending = pending[~ok]
    if alpha < 1.0:
        u = torch.empty(shape, device=device).uniform_(generator=gen)
        out = out * u.pow(1.0 / alpha)
    return out


def _gamma(p, c):
    out = _standard_gamma(p["alpha"], p["shape"] or (1,), c.rng, c.device)
    return (out * p["beta"]).to(p["dtype"])


def _exponential(p, c):
    out = torch.empty(p["shape"] or (1,), dtype=torch.float32,
                      device=c.device).exponential_(1.0, generator=c.rng)
    return (out / p["lam"]).to(p["dtype"])


def _poisson(lam, gen):
    """Poisson draws at the rates ``lam`` (a float32 tensor)."""
    if lam.device.type == "meta":
        return torch.empty_like(lam)
    return torch.poisson(lam, generator=gen)


def _poisson_op(p, c):
    lam = torch.full(p["shape"] or (1,), p["lam"], dtype=torch.float32,
                     device=c.device)
    return _poisson(lam, c.rng).to(p["dtype"])


def _gamma_poisson(k, prob, p, c):
    """A negative binomial draw: Poisson at a Gamma(k, (1 - prob) / prob)
    rate."""
    lam = _standard_gamma(k, p["shape"] or (1,), c.rng, c.device) \
        * ((1.0 - prob) / prob)
    return _poisson(lam, c.rng).to(p["dtype"])


def _neg_binomial(p, c):
    return _gamma_poisson(p["k"], p["p"], p, c)


def _gen_neg_binomial(p, c):
    k = 1.0 / p["alpha"]
    return _gamma_poisson(k, k / (k + p["mu"]), p, c)


_reg_sampler("_sample_gamma",
             (Param("alpha", float, 1.0), Param("beta", float, 1.0)),
             _gamma, aliases=("random_gamma",))
_reg_sampler("_sample_exponential", (Param("lam", float, 1.0),),
             _exponential, aliases=("random_exponential", "exponential"))
_reg_sampler("_sample_poisson", (Param("lam", float, 1.0),), _poisson_op,
             aliases=("random_poisson", "poisson"))
_reg_sampler("_sample_negbinomial",
             (Param("k", int, 1), Param("p", float, 1.0)), _neg_binomial,
             aliases=("random_negative_binomial", "negative_binomial"))
_reg_sampler("_sample_gennegbinomial",
             (Param("mu", float, 1.0), Param("alpha", float, 1.0)),
             _gen_neg_binomial,
             aliases=("random_generalized_negative_binomial",
                      "generalized_negative_binomial"))
