"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  The TPU package's Pallas kernels (``mxnet_tpu/op/pallas``) are
what they port; ``build`` compiles ``mxnet_tpu_torch/csrc`` at first use."""
from .flash_attention import flash_attention_fwd, attention_reference

__all__ = ["flash_attention_fwd", "attention_reference"]
