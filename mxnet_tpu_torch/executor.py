"""Graph evaluation (``mxnet_tpu/executor.py:_GraphProgram``), eval
forward only.

The JAX package traces the graph walk into one jitted XLA program; here
the walk runs eagerly, each node's op body launching its kernels as it
goes.  There is no jit and no program cache.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import random as _random
from .op.registry import OpContext
from .symbol import Symbol, _topo

__all__ = ["_GraphProgram"]


class _GraphProgram:
    """A Symbol's nodes in evaluation order, plus its argument metadata."""

    def __init__(self, sym: Symbol):
        self.sym = sym
        self.nodes = _topo([e[0] for e in sym._outputs])
        self.arg_names = sym.list_arguments()
        self.aux_names = sym.list_auxiliary_states()
        self.output_entries = list(sym._outputs)
        self._arg_index = {n: i for i, n in enumerate(self.arg_names)}
        self._aux_index = {n: i for i, n in enumerate(self.aux_names)}

    def _eval(self, arg_vals: Sequence[torch.Tensor],
              aux_vals: Sequence[torch.Tensor], device: torch.device):
        """Evaluate the graph in eval mode; returns the output tuple.
        ``device`` is where ops without tensor inputs create theirs."""
        ctx = OpContext(is_train=False, device=device,
                        rng=_random.generator(device))
        env = {}
        for n in self.nodes:
            if n.is_variable:
                env[(id(n), 0)] = arg_vals[self._arg_index[n.name]]
                continue
            in_vals = [env[(id(c), i)] for c, i in n.inputs]
            node_aux = [aux_vals[self._aux_index["%s_%s" % (n.name, a)]]
                        for a in n.aux_names()]
            outs, _ = n.op.apply(n.params, ctx, *(in_vals + node_aux))
            for i, v in enumerate(outs):
                env[(id(n), i)] = v
        return tuple(env[(id(nd), i)] for nd, i in self.output_entries)
