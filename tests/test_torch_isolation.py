"""The port stands alone: no module of ``mxnet_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and nothing runs on
the CPU unless the caller asks for it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mxnet_tpu_torch as mt

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _port_sources():
    """The port's modules, the card's smoke script, the scripts the
    launcher starts for the data-parallel tests and the elastic drill,
    and the runner of the examples under the port."""
    return sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py",
           ROOT / "tests" / "torch_elastic_train.py",
           ROOT / "tools" / "torch_run_example.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_sources_import_neither_jax_nor_mxnet_tpu():
    sources = _port_sources()
    assert len(sources) > 10 and all(p.exists() for p in sources)
    bad = [(str(p.relative_to(ROOT)), m) for p in sources
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mxnet_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "assert not bad, bad" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_predictor_raises_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with mt.name.NameManager():
        symbol = mt.models.transformer.get_symbol(
            seq_len=4, num_hidden=8, num_heads=2, num_layers=1, vocab_size=5)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.Predictor(symbol.tojson(), b"", {"data": (1, 4)})
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.Predictor(symbol.tojson(), b"", {"data": (1, 4)}, dev_type=2)
    assert mt.cpu().torch_device() == torch.device("cpu")


def test_the_port_builds_only_from_its_own_sources():
    """No port source names the JAX package's native libraries or a path
    into its ``native/`` tree: the native loader and the kernels build
    from ``mxnet_tpu_torch/csrc`` alone."""
    import re
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.op.kernels import build
    pattern = re.compile(r"mxnet_tpu/lib|libmxtpu_|\bnative/")
    sources = [p for p in (ROOT / "mxnet_tpu_torch").rglob("*")
               if p.suffix in (".py", ".cc", ".cu", ".cuh", ".h")] \
        + [ROOT / "chip_smoke.py"]
    assert any(p.suffix == ".cc" for p in sources)
    bad = [(str(p.relative_to(ROOT)), m.group(0)) for p in sources
           for m in pattern.finditer(p.read_text())]
    assert not bad
    csrc = ROOT / "mxnet_tpu_torch" / "csrc"
    assert _native.SOURCE.parent == build.CSRC == csrc
    assert build.BUILD_DIR == ROOT / "mxnet_tpu_torch" / "_build"
