"""Attention ops (``mxnet_tpu/op/attention.py``)."""
from __future__ import annotations

from .kernels.flash_attention import attention_reference, flash_attention
from .registry import Param, register


@register("_contrib_DotProductAttention",
          input_names=("query", "key", "value"),
          params_spec=(Param("causal", bool, False),
                       Param("scale", float, -1.0),
                       Param("flash", bool, True),
                       Param("block_q", int, 0),
                       Param("block_k", int, 0)),
          hint="dotproductattention")
def _dot_product_attention(p, c, q, k, v):
    """Exact multi-head attention over ``[batch, time, heads, dim]``.

    ``flash=True`` goes through ``FlashAttention``: the flash-attention
    kernels, forward and backward, on CUDA tensors (their plain versions
    on CPU tensors); ``flash=False`` the plain forward, differentiated by
    torch autograd.
    ``block_q``/``block_k`` are the JAX kernel's tile sizes: accepted so
    symbol JSON round-trips, and ignored, because the CUDA kernel
    chooses its own tile.
    """
    scale = None if p["scale"] <= 0 else p["scale"]
    if p["flash"]:
        return flash_attention(q, k, v, causal=p["causal"], scale=scale)
    return attention_reference(q, k, v, causal=p["causal"], scale=scale)[0]
