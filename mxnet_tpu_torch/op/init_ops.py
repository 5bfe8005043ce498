"""Creation ops (``mxnet_tpu/op/init_ops.py``)."""
from __future__ import annotations

import torch

from .registry import Param, register


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
