"""Random number state (``mxnet_tpu/random.py``).

The reference seeds one PRNG per device through its resource manager
(``include/mxnet/resource.h:59-72``, ``MXRandomSeed``).  Here
:func:`seed` does the same with one explicit ``torch.Generator`` per
device, made at first use and seeded alike; the global torch generator is
never touched.  Draws are deterministic per seed, but they are not the
JAX package's: its threefry keys and torch's generators give other
numbers from the same seed.  Tests that compare the two packages draw
their inputs with numpy.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["seed", "np_rng", "generator"]

_SEED = 0
_GENERATORS = {}
_NP_RNG = None


def seed(seed_state: int):
    """Seed every device's generator and the host numpy one (reference
    ``MXRandomSeed``, ``c_api.h:204``)."""
    global _SEED, _NP_RNG
    _SEED = int(seed_state)
    _GENERATORS.clear()
    _NP_RNG = _np.random.RandomState(_SEED)


def np_rng():
    """Host-side numpy RNG (weight init, data shuffling) sharing the seed
    set by :func:`seed`."""
    global _NP_RNG
    if _NP_RNG is None:
        _NP_RNG = _np.random.RandomState(_SEED)
    return _NP_RNG


def generator(device: torch.device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device`` with its index),
    seeded by the last :func:`seed`."""
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(_SEED)
        _GENERATORS[device] = gen
    return gen


# the sampling front-ends (uniform, normal) are re-exported here by the
# package __init__, as the JAX package does
