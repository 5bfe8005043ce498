"""Example scripts of ``examples/`` run unchanged under the port on the
CPU (``tools/torch_run_example.py --cpu``: ``import mxnet_tpu`` gives
the port), each to its own assert: the multi-task toy (a metric over two
outputs), the python-howto topics (the package's top-level names), and
the five scripts of the CustomOp, vision, detection and CTC families
(the SSD toy with 80 batches instead of 150; every other script with
its own settings).  One process runs them in turn, each from the port's
streams as a fresh process starts them."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    ("examples/multi-task/train_multi_task_toy.py", []),
    ("examples/python-howto/howtos.py", []),
    ("examples/numpy-ops/numpy_softmax.py", []),
    ("examples/torch-interop/torch_module.py", []),
    ("examples/warpctc/toy_ctc.py", []),
    ("examples/ssd/train_ssd_toy.py", ["--num-batches", "80"]),
    ("examples/rcnn/train_rcnn_toy.py", []),
]

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("examples") / "records.json")
    cmd = [sys.executable, os.path.join(ROOT, "tools",
                                        "torch_run_example.py"),
           "--cpu", "--record", out]
    for i, (path, args) in enumerate(EXAMPLES):
        cmd += (["--"] if i else []) + [os.path.join(ROOT, path)] + args
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert os.path.exists(out), res.stderr[-4000:]
    with open(out) as f:
        return {r["script"]: r for r in json.load(f)}


@pytest.mark.parametrize("path,args", EXAMPLES,
                         ids=[p.split("/")[1] for p, _ in EXAMPLES])
def test_example_reaches_its_assert_under_the_port(records, path, args):
    rec = records[path]
    assert rec["exit"] == 0, rec
    assert rec["argv"] == args and rec["modules"]
    # on the CPU every Module keeps the classic path, and none names a
    # refusal (that is for a gpu context)
    for m in rec["modules"]:
        assert not m["fused"] and m["fused_refused"] is None
