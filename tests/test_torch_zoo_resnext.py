"""The port's image-classification zoo against the JAX package's on the
CPU, third part: ResNeXt (grouped 3x3 convolutions, 32 groups) and
Inception-ResNet-v2 (the published 10/20/10 residual blocks), with the
checks and the tolerance of ``test_torch_zoo_convnets.py`` (names and
shapes at the published input; one forward and backward at batch 1 of
the smallest input each network takes, every gradient within 1e-5 of the
JAX executor's by relative norm); and the scalar ops of
Inception-ResNet-v2's residual scales, which a CUDA graph captures."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu_torch as mt

from test_torch_zoo_convnets import check_forward_backward, \
    check_names_and_shapes


@pytest.mark.parametrize("network,image", [
    ("resnext-50", 224), ("resnext-101", 224),
    ("inception-resnet-v2", 299)])
def test_symbols_match_the_jax_zoo(network, image):
    check_names_and_shapes(network, {}, image)


@pytest.mark.parametrize("network,image", [
    ("resnext-50", 32),
    ("inception-resnet-v2", 75),
])
def test_forward_backward_match_the_jax_executor(monkeypatch, network,
                                                 image):
    check_forward_backward(monkeypatch, network, {}, image)


class _Ops(TorchDispatchMode):
    """The aten ops dispatched inside the scope, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("op", ["_mul_scalar", "_plus_scalar",
                                "_rminus_scalar"])
def test_scalar_ops_make_their_scalar_on_the_device(op):
    """A scalar op (Inception-ResNet-v2's ``up * scale``) makes its scalar
    by a fill on the array's device, never from host data
    (``aten.lift_fresh``): a copy from the host fails a CUDA graph's
    capture, as the zoo's fused step showed on the card."""
    a = mt.nd.array([[1.0, -2.0], [0.5, 4.0]], ctx=mt.cpu())
    with _Ops() as ops:
        out = getattr(mt.nd, op)(a, scalar=0.17)
    assert "aten.lift_fresh.default" not in ops.names
    assert "aten.full.default" in ops.names
    want = {"_mul_scalar": a.data * 0.17, "_plus_scalar": a.data + 0.17,
            "_rminus_scalar": 0.17 - a.data}[op]
    assert torch.equal(out.data, want)
