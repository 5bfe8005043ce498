#!/usr/bin/env python
"""Run example scripts of ``examples/`` unchanged under the port.

The scripts import ``mxnet_tpu``; here that name (and every submodule
the port has loaded) is the port, ``mxnet_tpu_torch``, and ``jax`` is a
stand-in whose ``config.update`` does nothing (a few scripts pin the JAX
backend with it).  Each script runs as ``__main__`` from its own
directory, in turn, in this process, from the port's streams as a
fresh process starts them (``mt.random.seed(0)``), on the card (the
port's default context) or, with ``--cpu``, under ``with mt.cpu():``.
A script that exits with another code than 0, or raises, fails the
run; the scripts after it still run.

For each script the record names every Module it made: whether ``bind``
took the fused path, why not where a node ran Python
(``fused_refused``), and its fused Trainer's CUDA-graph captures and
replays, or why its steps ran uncaptured (``uncaptured``).

    python tools/torch_run_example.py [--cpu] [--record FILE] \\
        examples/ssd/train_ssd_toy.py --num-batches 80 \\
        -- examples/warpctc/toy_ctc.py
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import runpy
import sys
import time
import traceback
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mt  # noqa: E402


@contextlib.contextmanager
def as_the_reference():
    """Inside, ``import mxnet_tpu`` gives the port and ``jax`` a
    stand-in; the names go again after."""
    added = {}
    for name, mod in list(sys.modules.items()):
        if name == "mxnet_tpu_torch" or name.startswith("mxnet_tpu_torch."):
            added["mxnet_tpu" + name[len("mxnet_tpu_torch"):]] = mod
    stub = types.ModuleType("jax")
    stub.config = types.SimpleNamespace(update=lambda *a, **k: None)
    added["jax"] = stub
    taken = [n for n in added if n in sys.modules]
    if taken:
        raise RuntimeError("already imported: %s" % taken)
    sys.modules.update(added)
    try:
        yield
    finally:
        for name in added:
            sys.modules.pop(name, None)


def _module_record(mod):
    tr = getattr(mod, "_trainer", None)
    rec = {"fused": bool(mod._fused), "fused_refused": mod.fused_refused}
    if tr is not None:
        rec.update(graph_captures=tr.graph_captures,
                   graph_replays=tr.graph_replays,
                   uncaptured=tr.uncaptured)
    return rec


def run_script(path, argv, cpu=False):
    """Run one script as ``__main__`` with ``argv``; returns its record:
    the script, its exit code (1 and the traceback's end where it
    raised), its seconds and one entry per Module it made."""
    made = []
    init = mt.module.Module.__init__

    def tracking_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    path = os.path.abspath(path)
    saved = (list(sys.argv), list(sys.path))
    sys.argv = [path] + list(argv)
    sys.path.insert(0, os.path.dirname(path))
    mt.module.Module.__init__ = tracking_init
    # the port's streams as a fresh process starts them
    mt.random.seed(0)
    t0 = time.perf_counter()
    code, error = 0, None
    try:
        with mt.cpu() if cpu else contextlib.nullcontext():
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    except Exception:                  # noqa: BLE001 - recorded, fails
        code, error = 1, traceback.format_exc(limit=-8)
    finally:
        mt.module.Module.__init__ = init
        sys.argv, sys.path[:] = saved
    return {"script": os.path.relpath(path, ROOT), "argv": list(argv),
            "exit": code, "error": error,
            "seconds": time.perf_counter() - t0,
            "modules": [_module_record(m) for m in made]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--record", help="write the records here as JSON")
    ap.add_argument("scripts", nargs=argparse.REMAINDER,
                    help="script [args] [-- script [args] ...]")
    args = ap.parse_args(argv)
    runs, cur = [], []
    for a in args.scripts:
        if a == "--":
            runs.append(cur)
            cur = []
        else:
            cur.append(a)
    runs.append(cur)
    runs = [r for r in runs if r]
    if not runs:
        ap.error("no script given")
    with as_the_reference():
        records = [run_script(r[0], r[1:], args.cpu) for r in runs]
    for rec in records:
        print(json.dumps(rec), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(records, f, indent=1)
    return 1 if any(r["exit"] for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
