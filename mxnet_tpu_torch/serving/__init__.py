"""Serving: the eval forward over weights that live on the device."""
from .compiled import CompiledForward, infer_input_dtypes

__all__ = ["CompiledForward", "infer_input_dtypes"]
