"""The serving forward (``mxnet_tpu/serving/compiled.py``).

:class:`CompiledForward` is a symbol's eval forward with the **weights as
arguments**: the caller keeps the weights on the device once and passes
them with each batch, under the JAX package's ``input_names`` /
``param_names`` contract.  The JAX version jits this function; the port
runs it eagerly, so there is nothing to compile and the name only keeps
the contract's.  The JAX package's persisted-program and ahead-of-time
machinery has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..base import MXNetError
from ..executor import _GraphProgram

__all__ = ["CompiledForward", "infer_input_dtypes"]


def infer_input_dtypes(symbol, params, input_names: Sequence[str]) -> Dict:
    """The staging dtype per input: what ``infer_type`` back-derives
    from the LOADED param dtypes (a bf16 checkpoint binds bf16 inputs),
    else float32."""
    inferred = {}
    try:
        types, _, _ = symbol.infer_type(
            **{n: v.dtype for n, v in params.items()})
        inferred = {n: t for n, t in zip(symbol.list_arguments(), types)
                    if t is not None}
    except MXNetError:
        pass
    return {n: inferred.get(n, torch.float32) for n in input_names}


class CompiledForward:
    """A symbol's inference forward, weights as arguments."""

    def __init__(self, symbol, input_names: Sequence[str]):
        self.symbol = symbol
        self.prog = _GraphProgram(symbol)
        self.input_names = tuple(input_names)
        missing = [n for n in self.input_names
                   if n not in self.prog.arg_names]
        if missing:
            raise MXNetError("inputs %s are not arguments of this symbol "
                             "(have %s)" % (missing, self.prog.arg_names))
        inputs = set(self.input_names)
        self.param_names = [n for n in self.prog.arg_names if n not in inputs]
        self.aux_names = list(self.prog.aux_names)

    def run(self, params: Dict[str, torch.Tensor],
            aux: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Execute the forward on the device the batch lies on; returns
        the output tuple.  ``params``, ``aux`` and ``batch`` map names to
        tensors on that device."""
        device = batch[self.input_names[0]].device
        vals = [batch[n] if n in self.input_names else params[n]
                for n in self.prog.arg_names]
        with torch.inference_mode():
            return self.prog._eval(vals, [aux[n] for n in self.aux_names],
                                   device)[0]
