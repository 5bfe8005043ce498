"""Parameters of the JAX package as the port's tensors.

``mxnet_tpu`` and ``mxnet_tpu_torch`` name every parameter alike, so a
checkpoint converts by moving each array, unchanged, onto a torch device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["params_from_mxnet_tpu"]


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, NDArray):
        return arr.data.clone()
    a = np.array(arr, order="C")    # a writable host copy
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the bits through int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_mxnet_tpu(arg_params: Dict, aux_params: Dict,
                          device="cpu"
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """``(arg_params, aux_params)`` of numpy arrays (``NDArray.asnumpy()``
    of the JAX package's) or of the port's NDArrays -> the same dicts of
    tensors on ``device``, in the same dtypes."""
    device = torch.device(device)
    return ({k: _tensor(v).to(device) for k, v in arg_params.items()},
            {k: _tensor(v).to(device) for k, v in aux_params.items()})
