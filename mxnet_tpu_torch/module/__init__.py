"""Module API (``mxnet_tpu/module``): Module (fused or classic path),
BucketingModule (one shared-parameter Module per sequence length),
SequentialModule (modules in a chain) and the Python-computed
PythonModule and PythonLossModule."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "DataParallelExecutorGroup",
           "Module", "PythonLossModule", "PythonModule", "SequentialModule"]
