"""Parity helpers for the port's tests: the same numpy inputs through the
JAX package and the port on the CPU, forward and backward, by op body
(``jax.vjp`` beside ``torch.autograd.grad``) or by bound symbol
(``check_against_reference``).  Not a test module: the ``test_torch_*``
files import it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import mxnet_tpu as mx
from mxnet_tpu.op import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.op import registry as treg

_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def jax_apply(name, kw, ins, aux=(), is_train=True, cots=None,
              dtype="float32", seed=None, jit=False):
    """The JAX op ``name`` on ``ins`` (+ ``aux``): ``(outputs, new aux,
    gradients of the floating inputs for the cotangents cots)`` as
    float32 numpy (a non-floating input's gradient is None).  With a
    ``seed`` and no ``cots`` the cotangents are ``cotangents(outputs,
    seed)``, returned as a fourth element.  ``jit`` compiles the op
    once, where running it primitive by primitive would take seconds
    (the scans of the detection ops)."""
    op = jreg.get(name)
    p = op.parse_params(dict(kw))
    ctx = jreg.OpContext(is_train=is_train, rng=jax.random.key(0),
                         platform="cpu")
    diff = [i for i, a in enumerate(ins) if _floating(a)]
    xs = [jnp.asarray(a).astype(dtype) if _floating(a) else jnp.asarray(a)
          for a in ins]
    aux_j = [jnp.asarray(a).astype(dtype) for a in aux]

    def f(*d):
        full = list(xs)
        for i, v in zip(diff, d):
            full[i] = v
        return op.apply(p, ctx, *full, *aux_j)

    (outs, new_aux), vjp = jax.vjp(jax.jit(f) if jit else f,
                                   *[xs[i] for i in diff])
    grads = [None] * len(ins)
    made = cots is None and seed is not None
    if made:
        cots = cotangents([np.zeros(o.shape) for o in outs], seed)
    if cots is not None:
        got = vjp((tuple(jnp.asarray(c).astype(o.dtype)
                         for c, o in zip(cots, outs)),
                   tuple(jnp.zeros_like(a) for a in new_aux)))
        for i, g in zip(diff, got):
            grads[i] = np.asarray(g.astype(jnp.float32))

    def host(vals):
        return [np.asarray(jnp.asarray(v).astype(jnp.float32)) for v in vals]

    if made:
        return host(outs), host(new_aux), grads, cots
    return host(outs), host(new_aux), grads


def port_apply(name, kw, ins, aux=(), is_train=True, cots=None,
               dtype="float32", device="cpu", rng=None):
    """The port's op on the same inputs (on ``device``), with torch
    autograd; the same return as :func:`jax_apply`."""
    op = treg.get(name)
    p = op.parse_params(dict(kw))
    dev = torch.device(device)
    ctx = treg.OpContext(is_train=is_train, record=True, device=dev,
                         rng=rng)
    dt = _TORCH_DT[dtype]
    xs = []
    for a in ins:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        xs.append(t.to(dt).requires_grad_() if _floating(a) else t)
    aux_t = [torch.from_numpy(np.asarray(a)).to(dev, dt) for a in aux]
    outs, new_aux = op.apply(p, ctx, *xs, *aux_t)
    grads = [None] * len(ins)
    if cots is not None:
        diff = [i for i, a in enumerate(ins) if _floating(a)]
        heads = [(o, torch.from_numpy(np.asarray(c)).to(dev, o.dtype))
                 for o, c in zip(outs, cots) if o.requires_grad]
        if heads and diff:
            got = torch.autograd.grad([h for h, _ in heads],
                                      [xs[i] for i in diff],
                                      [c for _, c in heads],
                                      allow_unused=True)
        else:
            got = [None] * len(diff)
        for i, g in zip(diff, got):
            grads[i] = (torch.zeros_like(xs[i]) if g is None else g) \
                .detach().float().cpu().numpy()

    def host(vals):
        return [v.detach().float().cpu().numpy() for v in vals]

    return host(outs), host(new_aux), grads


def cotangents(outs, seed=1):
    """Random cotangents for ``outs``, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(o.shape).astype(np.float32) for o in outs]


def both(name, kw, ins, aux=(), is_train=True, dtype="float32", seed=1,
         jit=False):
    """Both ops with the same random cotangents: ``(port, jax)``."""
    *want, cots = jax_apply(name, kw, ins, aux, is_train, None, dtype, seed,
                            jit)
    got = port_apply(name, kw, ins, aux, is_train, cots, dtype)
    return got, tuple(want)


def rel_err(got, want):
    """The largest difference over the largest magnitude (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not got.size:
        return 0.0
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1.0)


def assert_close(got, want, tol, what=""):
    """Every array of ``got`` within ``tol`` of ``want``'s (``rel_err``);
    None on both sides for an input without a gradient."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (what, i)
            continue
        err = rel_err(g, w)
        assert err <= tol, "%s[%d]: %.3g > %.3g" % (what, i, err, tol)


def check_against_reference(sym_fn, location, dtype="float32", tol=1e-5,
                            aux_states=None, is_train=True, seed=1,
                            grad_nodes=None):
    """Build ``sym_fn(mx)`` and ``sym_fn(mt)``, bind both on the CPU to
    the numpy ``location`` (and ``aux_states``), run a forward (training
    unless ``is_train`` is False) and, in training, a backward with the
    same random head gradients; every output, aux state and gradient of
    ``grad_nodes`` (default: every floating argument) within ``tol``
    (``rel_err``).  Returns ``(port, jax)``, each ``{"outputs": [...],
    "grads": {...}, "aux": {...}}`` as numpy."""
    with mx.name.NameManager():
        jsym = sym_fn(mx)
    with mt.name.NameManager():
        tsym = sym_fn(mt)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    names = grad_nodes or [n for n in jsym.list_arguments()
                           if _floating(location[n])]
    results = []
    cots = None
    for pkg, sym in ((mx, jsym), (mt, tsym)):
        ctx = pkg.cpu()
        args = {n: pkg.nd.array(np.asarray(v), ctx=ctx).astype(dtype)
                for n, v in location.items()}
        grads = {n: pkg.nd.zeros(args[n].shape, ctx=ctx, dtype=dtype)
                 for n in names} if is_train else None
        aux = {n: pkg.nd.array(np.asarray(v), ctx=ctx).astype(dtype)
               for n, v in (aux_states or {}).items()}
        exe = sym.bind(ctx, args=args, args_grad=grads,
                       grad_req={n: "write" for n in names}
                       if is_train else "null", aux_states=aux)
        outs = exe.forward(is_train=is_train)
        outs = [o.astype("float32").asnumpy() for o in outs]
        got = {}
        if is_train:
            if cots is None:
                cots = cotangents(outs, seed)
            exe.backward([pkg.nd.array(c, ctx=ctx).astype(dtype)
                          for c in cots])
            got = {n: grads[n].astype("float32").asnumpy() for n in names}
        results.append({"outputs": outs, "grads": got,
                        "aux": {n: exe.aux_dict[n].astype("float32")
                                .asnumpy() for n in exe.aux_dict}})
    want, port = results
    assert_close(port["outputs"], want["outputs"], tol, "outputs")
    for n in names:
        assert_close([port["grads"].get(n)], [want["grads"].get(n)], tol,
                     "grad " + n)
    for n in want["aux"]:
        assert_close([port["aux"][n]], [want["aux"][n]], tol, "aux " + n)
    return port, want
