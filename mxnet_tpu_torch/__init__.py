"""PyTorch/CUDA port of ``mxnet_tpu``: the same names and module layout,
torch tensors inside, hand-written Hopper kernels where the JAX package
has Pallas kernels.  It imports neither JAX nor ``mxnet_tpu``.

It serves models through :class:`Predictor` and the continuous-batching
``serving.ModelServer`` (one CUDA graph per tenant and shape bucket on
the card), trains the transformer LM and
the zoo's convnets (ResNet, LeNet, the MLP) and segmentation networks
(FCN-xs, through ``Deconvolution`` and ``Crop``) through
``mx.mod.Module.fit`` (on the card, the fused :class:`parallel.Trainer`
step captured in one CUDA graph; elsewhere, or with
``MXTPU_MODULE_FUSED=never``, the classic executor path), with
crash-consistent checkpoints and resume (``mx.resilience``), a
``mx.monitor.Monitor`` and ``Module.reshape``, chains modules
(``SequentialModule``, ``PythonLossModule``, ``mx.model.FeedForward``),
trains the
bucketing LSTM LM through ``mx.mod.BucketingModule`` (``mx.rnn`` cells,
``BucketSentenceIter``, one parameter set for every bucket), and runs the
imperative path: ``mx.nd`` NDArrays and the ops they reach, recorded by
``mx.autograd``, and ``mx.rtc`` kernels compiled from CUDA C at runtime.
Training reads RecordIO files of JPEGs through ``mx.io.ImageRecordIter``
(a native loader built from ``csrc/dataloader.cc``), staged onto the card
and augmented there (``DeviceUploadIter``, ``StreamAugmentIter``,
``DeviceCacheIter``), with ``mx.kvstore`` stores.  Under
``tools/launch.py`` (``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCESSES``,
``MXTPU_PROCESS_ID``) the import joins a ``torch.distributed`` group and
``fit`` with a ``dist_sync`` store trains data-parallel over the worker
processes, elastic (``mx.elastic``: a dead rank shrinks the world, which
``tools/launch.py --local-elastic`` relaunches and which resumes from its
checkpoints) and guarded against silent corruption (``mx.integrity``:
state fingerprints, replica votes, replay audits and rollback to the
newest verified checkpoint).
"""
from . import base
from .base import Context, MXNetError, cpu, gpu, current_context
from . import name
from . import attribute
from .attribute import AttrScope
from . import op
from . import ndarray
from . import ndarray as nd
from . import random
from . import symbol
from . import symbol as sym
from .symbol import Variable, Group
from . import executor
from .executor import Executor
from . import autograd
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from .optimizer import Optimizer
from . import metric
from . import recordio
from . import io
from . import image
from . import image as img
from . import kvstore
from . import kvstore as kv
from . import model
from .model import FeedForward
from . import callback
from . import monitor
from . import monitor as mon
from .monitor import Monitor
from . import resilience
from .resilience import CheckpointManager
from . import module
from . import module as mod
from .module import Module
from . import test_utils
from . import operator
from .operator import CustomOp, CustomOpProp
from . import contrib
from . import rnn
from . import parallel
from . import obs
from . import faults
from . import serving
from . import predictor
from .predictor import Predictor
from . import models
from . import convert
from . import rtc
from . import envknobs
from . import health
from . import integrity
from .integrity import IntegrityError  # noqa: F401
from . import elastic
from . import executor_manager
from .executor_manager import DataParallelExecutorGroup  # noqa: F401

import os as _os  # noqa: E402
if _os.environ.get("MXTPU_COORDINATOR"):
    # join the launcher's process group (tools/launch.py) before any
    # training code asks for its rank or its card
    parallel.collectives.join_from_env()

# one scan of the MXTPU_* env surface per process: a typo'd knob warns
# with a did-you-mean instead of silently configuring nothing;
# MXTPU_STRICT_KNOBS=1 raises instead
envknobs.validate_environ()

# sampling front-ends re-exported on mx.random (reference mxnet/random.py)
for _sampler in ("uniform", "normal"):
    setattr(random, _sampler, getattr(ndarray, _sampler))

ndarray.Custom = operator._custom_entry("nd")
symbol.Custom = operator._custom_entry("sym")

# contrib namespaces: every ``_contrib_<name>`` op also as
# ``mx.sym.contrib.<name>`` and ``mx.nd.contrib.<name>``
import types as _types  # noqa: E402
symbol.contrib = _types.SimpleNamespace()
ndarray.contrib = _types.SimpleNamespace()
for _n in sorted(set(op.registry._REGISTRY) | set(op.registry._ALIASES)):
    if _n.startswith("_contrib_"):
        setattr(symbol.contrib, _n[len("_contrib_"):], getattr(symbol, _n))
        setattr(ndarray.contrib, _n[len("_contrib_"):], getattr(ndarray, _n))
