"""Parallelism (``mxnet_tpu/parallel``): the fused train step and the
data-parallel layer under it.

  * :mod:`mesh`        — named meshes over the worker processes (the
                         ``data`` axis)
  * :mod:`collectives` — joining ``torch.distributed`` from the launcher's
                         environment; broadcast, all-reduce, barrier, the
                         bfloat16-wire gradient sum
  * :mod:`optim`       — optimizer update rules over every parameter
  * :mod:`trainer`     — the fused step: forward, backward, the gradient
                         sum over the ranks and the update, one CUDA graph
                         on the card

Tensor, pipeline, sequence and expert parallelism (ring attention, the
pipeline schedule, MoE) wait for ROADMAP item 7.
"""
from .mesh import (Mesh, get_mesh, current_mesh, data_parallel_mesh,
                   global_data_parallel_mesh, make_mesh, use_mesh)
from .collectives import global_allreduce, barrier
from .optim import make_update_fn
from .trainer import Trainer, remat_policy

__all__ = ["Mesh", "get_mesh", "current_mesh", "data_parallel_mesh",
           "global_data_parallel_mesh", "make_mesh", "use_mesh",
           "global_allreduce", "barrier", "Trainer", "remat_policy",
           "make_update_fn"]
