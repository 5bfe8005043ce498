"""The port's top-level names against the JAX package's: every name of
``dir(mxnet_tpu)`` is one of ``dir(mxnet_tpu_torch)`` but those of the
modules still to port, listed here by ROADMAP item, and ``tpu`` (the
port's device is ``gpu``), so a name that drops out later shows up.
Both packages are imported fresh in a subprocess, as a user's script
imports them."""
import json
import os
import subprocess
import sys

import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ROADMAP item -> the top-level names of its modules, not ported yet
NOT_PORTED = {
    "9": {"profiler", "viz", "visualization", "engine", "program",
          "storage", "resource", "tuneplan", "c_api_support"},
    "10": {"analysis"},
}
# the JAX package's device constructor: the port's device is ``gpu``
BY_DESIGN = {"tpu"}


def _names():
    code = ("import json, mxnet_tpu, mxnet_tpu_torch; "
            "print(json.dumps([sorted(dir(mxnet_tpu)), "
            "sorted(dir(mxnet_tpu_torch))]))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return [set(x) for x in json.loads(out.strip().splitlines()[-1])]


def test_every_top_level_name_but_the_unported_items():
    jax_names, port_names = _names()
    missing = {n for n in jax_names - port_names
               if not n.startswith("_")} - BY_DESIGN
    by_item = {item: sorted(missing & names)
               for item, names in NOT_PORTED.items()}
    assert missing == set().union(*by_item.values()), sorted(
        missing - set().union(*by_item.values()))
    assert by_item["10"] == ["analysis"]
    assert {"profiler", "viz"} <= set(by_item["9"])


def test_the_aliases_are_the_modules_and_classes():
    """The reference's aliases and re-exports (``mxnet_tpu/__init__.py``)
    name the port's own modules and classes."""
    assert mt.kv is mt.kvstore and mt.mon is mt.monitor
    assert mt.img is mt.image and mt.mod is mt.module
    assert mt.Module is mt.module.Module and mt.Monitor is mt.monitor.Monitor
    assert mt.Executor is mt.executor.Executor
    assert mt.Group is mt.symbol.Group and mt.sym.var is mt.sym.Variable
    assert mt.Optimizer is mt.optimizer.Optimizer
    assert mt.FeedForward is mt.model.FeedForward
    assert mt.CheckpointManager is mt.resilience.CheckpointManager
    assert mt.CustomOp is mt.operator.CustomOp
    assert mt.CustomOpProp is mt.operator.CustomOpProp
    assert mt.model.BatchEndParam._fields == (
        "epoch", "nbatch", "eval_metric", "locals")
    assert mt.test_utils.__name__ == "mxnet_tpu_torch.test_utils"
