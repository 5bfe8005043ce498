"""Deploy-only predictor (``mxnet_tpu/predictor.py``), the analog of the
reference's predict-only C API (``include/mxnet/c_predict_api.h``): load
a saved symbol + params, feed inputs, fetch outputs.

The weights move to the device once, at construction; every forward
runs :class:`~mxnet_tpu_torch.serving.CompiledForward` over them.  The
device is the card unless the caller asks for the CPU: with no CUDA
device and no explicit ``dev_type="cpu"``, construction raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .base import Context, MXNetError
from . import ndarray as nd
from . import symbol as sym
from .serving.compiled import CompiledForward, infer_input_dtypes

__all__ = ["Predictor"]


def _load_params_bytes(blob: bytes):
    """Parse a ``prefix-NNNN.params`` blob (reference
    ``c_predict_api.cc:87-117``): ``arg:``/``aux:`` prefixed names,
    unprefixed names are args.  Returns dicts of host tensors."""
    arg_params, aux_params = {}, {}
    for k, v in nd.load_buffer(blob).items():
        v = v.data
        if k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k[4:] if k.startswith("arg:") else k] = v
    return arg_params, aux_params


class Predictor(object):
    """Forward-only inference over a saved model.

    Parameters
    ----------
    symbol_json : str
        the ``*-symbol.json`` content.
    param_bytes : bytes
        the ``*.params`` file content.
    input_shapes : dict name -> shape
        every data input's shape (batch included).
    dev_type/dev_id : str or int, int
        ``"gpu"`` (2, the default) or ``"cpu"`` (1) and the device index.

    A loss layer's label input (a name ending in ``label``) that is not
    declared is zero-filled on every forward; its value is unused.  When
    shape inference cannot reach such a label from the declared inputs
    (a language model's label passes through a ``Reshape`` before its
    loss layer), it takes the shape of the first declared input.
    """

    def __init__(self, symbol_json: str, param_bytes: bytes,
                 input_shapes: Dict[str, Sequence[int]],
                 dev_type="gpu", dev_id: int = 0):
        self.device = Context(dev_type, dev_id).torch_device()
        self.symbol = sym.load_json(symbol_json)
        arg_params, aux_params = _load_params_bytes(param_bytes)
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}

        arg_names = self.symbol.list_arguments()
        aux_names = self.symbol.list_auxiliary_states()
        known = dict(self.input_shapes)
        partial, _, _ = self.symbol.infer_shape_partial(**known)
        for name, shape in zip(arg_names, partial):
            if shape is None and name.endswith("label"):
                known[name] = next(iter(self.input_shapes.values()))
        arg_shapes, out_shapes, aux_shapes = self.symbol.infer_shape(**known)
        if arg_shapes is None:
            raise MXNetError("cannot infer every argument's shape from %s"
                             % self.input_shapes)
        self._out_shapes = [tuple(s) for s in out_shapes]

        self._params = {}
        label_shapes = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in self.input_shapes:
                continue
            if name in arg_params:
                if tuple(arg_params[name].shape) != tuple(shape):
                    raise MXNetError(
                        "param %s shape %s != expected %s"
                        % (name, tuple(arg_params[name].shape), tuple(shape)))
                self._params[name] = arg_params[name].to(self.device)
            elif name.endswith("label"):
                label_shapes[name] = tuple(shape)
            else:
                raise MXNetError(
                    "parameter %s missing from the params blob" % name)
        self._aux = {}
        for name, shape in zip(aux_names, aux_shapes):
            self._aux[name] = aux_params[name].to(self.device) \
                if name in aux_params \
                else torch.zeros(shape, dtype=torch.float32, device=self.device)

        # staging dtypes: what type inference derives from the LOADED
        # params (a bf16 checkpoint binds bf16 inputs), f32 fallback
        self._input_dtypes = infer_input_dtypes(
            self.symbol, self._params,
            list(self.input_shapes) + list(label_shapes))
        self._labels = {n: torch.zeros(s, dtype=self._input_dtypes[n],
                                       device=self.device)
                        for n, s in label_shapes.items()}
        self._cf = CompiledForward(
            self.symbol, list(self.input_shapes) + list(label_shapes))
        self._inputs: Dict[str, torch.Tensor] = {}
        self._outputs: Optional[List[torch.Tensor]] = None

    @classmethod
    def from_checkpoint(cls, prefix: str, epoch: int,
                        input_shapes: Dict[str, Sequence[int]],
                        dev_type="gpu", dev_id: int = 0):
        with open("%s-symbol.json" % prefix) as f:
            symbol_json = f.read()
        with open("%s-%04d.params" % (prefix, epoch), "rb") as f:
            param_bytes = f.read()
        return cls(symbol_json, param_bytes, input_shapes, dev_type, dev_id)

    # -- c_predict_api-shaped surface ---------------------------------
    def input_dtype(self, name: str) -> torch.dtype:
        """The dtype ``set_input`` stages ``name`` in."""
        if name not in self.input_shapes:
            raise MXNetError("%s is not a declared input" % name)
        return self._input_dtypes[name]

    def set_input(self, name: str, value) -> None:
        """Stage one input (a tensor, or anything ``torch.as_tensor``
        takes) on the predictor's device, in its staging dtype."""
        if name not in self.input_shapes:
            raise MXNetError("%s is not a declared input" % name)
        t = torch.as_tensor(value)
        if tuple(t.shape) != self.input_shapes[name]:
            raise MXNetError("input %s shape %s != declared %s"
                             % (name, tuple(t.shape), self.input_shapes[name]))
        self._inputs[name] = t.to(device=self.device,
                                  dtype=self._input_dtypes[name])

    def forward(self) -> None:
        missing = [n for n in self.input_shapes if n not in self._inputs]
        if missing:
            raise MXNetError("set_input(%s) before forward()" % missing)
        feed = dict(self._inputs, **self._labels)
        self._outputs = list(self._cf.run(self._params, self._aux, feed))

    def get_output_shape(self, index: int):
        return self._out_shapes[index]

    @property
    def num_outputs(self) -> int:
        return len(self._out_shapes)

    def get_output(self, index: int) -> torch.Tensor:
        """Output ``index`` as computed: a tensor on the predictor's
        device, in the program's own dtype (``.cpu()`` for a host
        copy)."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index]

    def predict(self, **inputs) -> List[torch.Tensor]:
        """Convenience: set every input, forward, return all outputs."""
        for name, value in inputs.items():
            self.set_input(name, value)
        self.forward()
        return [self.get_output(i) for i in range(self.num_outputs)]
