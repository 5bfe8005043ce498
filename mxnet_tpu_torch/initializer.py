"""Weight initializers (``mxnet_tpu/initializer.py``).

The reference surface (``python/mxnet/initializer.py:14-500``):
:class:`InitDesc`, :class:`Initializer` with its default rules by name
suffix (``*_weight`` by the subclass's rule, ``*_bias``/``*_beta`` zero,
``*_gamma`` one, moving statistics), the :class:`Load` and
:class:`Mixed` combinators, and ``Zero``, ``One``, ``Constant``,
``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``,
``Bilinear`` and ``LSTMBias``. Values are drawn on the host from
:func:`mxnet_tpu_torch.random.np_rng`, as the JAX package draws them, so
one seed gives the same weights in both packages, then written into the
array on its device.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np

from .base import MXNetError
from . import ndarray
from . import random as _random

_INIT_REGISTRY = {}


class InitDesc(str):
    """Name + attrs descriptor passed to initializers
    (reference ``initializer.py:14-31``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    """Register an initializer class under its lowercased name."""
    name = klass.__name__.lower()
    _INIT_REGISTRY[name] = klass
    return klass


class Initializer(object):
    """Base initializer: dispatches on the variable *name* suffix exactly like
    the reference (``initializer.py:94-179``): ``*_weight`` -> _init_weight,
    ``*_bias``/``*_beta`` -> zero, ``*_gamma`` -> one, moving stats, etc."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be an InitDesc or string")
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            create(desc.attrs["__init__"])._init_weight(desc, arr)
            return
        self._legacy_init(str(desc), arr)

    # suffix -> handler-method name; checked in order, first match wins.
    # prefixed special cases (upsampling bilinear kernels, spatial-
    # transformer localization nets) are handled before this table.
    _SUFFIX_RULES = (
        ("bias", "_init_bias"),
        ("gamma", "_init_gamma"),
        ("beta", "_init_beta"),
        ("weight", "_init_weight"),
        ("moving_mean", "_init_zero"),
        ("moving_inv_var", "_init_zero"),
        ("moving_var", "_init_one"),
        ("moving_avg", "_init_zero"),
    )

    def _legacy_init(self, name, arr):
        if not isinstance(arr, ndarray.NDArray):
            raise TypeError("arr must be NDArray")
        if name.startswith("upsampling"):
            return self._init_bilinear(name, arr)
        if name.startswith("stn_loc"):
            return (self._init_loc_bias if name.endswith("bias")
                    else self._init_zero)(name, arr)
        for suffix, handler in self._SUFFIX_RULES:
            if name.endswith(suffix):
                return getattr(self, handler)(name, arr)
        self._init_default(name, arr)

    def _init_bilinear(self, _, arr):
        # separable triangular (hat) filter, the standard bilinear
        # upsampling kernel — vectorized over the spatial grid
        h, w = arr.shape[2], arr.shape[3]
        f = np.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        hat_x = 1 - np.abs(np.arange(w) / f - c)
        hat_y = 1 - np.abs(np.arange(h) / f - c)
        kernel = np.outer(hat_y, hat_x).astype(np.float32)
        arr[:] = np.broadcast_to(kernel, arr.shape)

    def _init_loc_bias(self, _, arr):
        if arr.shape[0] != 6:
            raise MXNetError("assert error: loc bias shape[0] must be 6")
        arr[:] = np.array([1.0, 0, 0, 0, 1.0, 0], dtype=np.float32)

    @staticmethod
    def _const_fill(arr, value):
        arr[:] = value

    # the constant-fill family (bias/beta/moving stats start at 0;
    # gamma/moving var at 1) — all route through one filler
    def _init_zero(self, _, arr):
        self._const_fill(arr, 0.0)

    def _init_one(self, _, arr):
        self._const_fill(arr, 1.0)

    _init_bias = _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "covers: weight, bias, gamma (scale), beta (shift). Give names "
            "matching those patterns or use Mixed/attr-based init." % name)


class Load(object):
    """Init from an existing param dict (reference ``initializer.py:181``)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            param = ndarray.load(param)
        self.param = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                self.param[name[4:]] = arr
            else:
                self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if arr.shape != self.param[name].shape:
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, arr.shape, self.param[name].shape))
            arr[:] = self.param[name]
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise MXNetError(
                    "Cannot Initialize %s. Not found in loaded param and no "
                    "default initializer provided." % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


class Mixed(object):
    """Regex-pattern dispatch to multiple initializers
    (reference ``initializer.py:224``)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same length")
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Add a \".*\" "
            "pattern at the end with default Initializer." % name)


@register
class Zero(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _random.np_rng().uniform(-self.scale, self.scale, arr.shape)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _random.np_rng().normal(0, self.sigma, arr.shape)


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix (the SVD factor of a random one whose
    shape is the weight's, flattened to ``(out, rest)``)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _random.np_rng().uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _random.np_rng().normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * res).reshape(arr.shape)


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        if arr.ndim < 2:
            raise ValueError("Xavier needs a >=2D weight, got %s for %s"
                             % (arr.shape, name))
        # receptive-field size folds into both fans for conv weights
        rf = int(np.prod(arr.shape[2:])) if arr.ndim > 2 else 1
        fan_in, fan_out = arr.shape[1] * rf, arr.shape[0] * rf
        try:
            factor = {"avg": (fan_in + fan_out) / 2.0,
                      "in": fan_in, "out": fan_out}[self.factor_type]
        except KeyError:
            raise ValueError("factor_type must be avg/in/out, got %r"
                             % self.factor_type)
        scale = np.sqrt(self.magnitude / factor)
        rng = _random.np_rng()
        if self.rnd_type == "uniform":
            arr[:] = rng.uniform(-scale, scale, arr.shape)
        elif self.rnd_type == "gaussian":
            arr[:] = rng.normal(0, scale, arr.shape)
        else:
            raise ValueError("rnd_type must be uniform/gaussian, got %r"
                             % self.rnd_type)


@register
class MSRAPrelu(Xavier):
    """He initialisation for PReLU slopes: Xavier gaussian at magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel for every weight."""

    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        self._init_bilinear(_, arr)


@register
class LSTMBias(Initializer):
    """Forget-gate bias init for an LSTM's fused ``i2h_bias`` (gates i, f,
    c, o): ``forget_bias`` on the f quarter, 0 elsewhere (reference
    ``initializer.py:429-449``).  ``LSTMCell`` puts it on its bias
    variable's ``__init__`` attribute."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        num_hidden = int(arr.shape[0] / 4)
        v = np.zeros(arr.shape, dtype=np.float32)
        v[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = v


def create(init):
    """Create an initializer from a string name, json dump, or instance."""
    if callable(init) and not isinstance(init, str):
        return init
    if isinstance(init, str):
        try:
            name, kwargs = json.loads(init)
            return _INIT_REGISTRY[name.lower()](**kwargs)
        except (ValueError, KeyError):
            if init.lower() in _INIT_REGISTRY:
                return _INIT_REGISTRY[init.lower()]()
    raise MXNetError("cannot create initializer from %r" % (init,))
