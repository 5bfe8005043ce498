"""Module API (``mxnet_tpu/module``): Module (fused or classic path) and
BucketingModule (one shared-parameter Module per sequence length)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "DataParallelExecutorGroup",
           "Module"]
