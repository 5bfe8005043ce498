#!/usr/bin/env python3
"""Where the card's fused Trainer and the CPU's part on the loss-layer
examples, and why: the measurement behind ``chip_smoke.py``'s
loss_examples gate on the fused path.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_fused_divergence.py

Each example of ``chip_smoke.LOSS_EXAMPLES`` runs on Module's fused path
(``MXTPU_MODULE_FUSED`` ``auto`` on the card, ``always`` on the CPU) from
the same seed, every Trainer step recorded: its inputs, the parameters
and the optimizer state after it.  Three runs are held against the CPU's:
the card's as the step runs there (one CUDA graph, replayed), the card's
with every step eager (no graph), and the card's with ``fit``'s epoch-end
refresh re-creating the optimizer state, as the JAX package's fused
``fit`` does (``mxnet_tpu/module/module.py:217-220``), against a CPU run
that does the same.  One JSON line an example: for each comparison the
first step whose parameters or state part by more than 1e-4 of their
largest magnitude (null if none), the largest relative norm between the
final parameters, and each run's end-of-run score.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.module import module as module_mod  # noqa: E402
from mxnet_tpu_torch.parallel import trainer as trainer_mod  # noqa: E402

PART = 1e-4
TRAINER = trainer_mod.Trainer
STEP, GRAPH_STEP = TRAINER.step, TRAINER._graph_step
SET_PARAMS = TRAINER.set_params


def _host(tree):
    return [t.detach().float().cpu().numpy().copy()
            for t in trainer_mod._leaves(tree)]


def _recorded(log):
    def step(self, batch, lr=None):
        outs = STEP(self, batch, lr)
        log.append({"params": _host(self.params),
                    "state": _host(self.opt_state)})
        return outs
    return step


def _eager_graph_step(self, batch):
    return self._step_core(batch)


def _recreating_set_params(self, arg_params, aux_params=None):
    """The JAX package's epoch-end refresh: the values and a fresh
    optimizer state."""
    self.init_params(arg_params=arg_params, aux_params=aux_params,
                     force_init=True)


def run(fn, device, eager=False, recreate=False):
    log = []
    TRAINER.step = _recorded(log)
    TRAINER._graph_step = _eager_graph_step if eager else GRAPH_STEP
    # Module.init_params, which fit's epoch-end set_params reaches, hands
    # the values to Trainer.set_params
    TRAINER.set_params = _recreating_set_params if recreate else SET_PARAMS
    try:
        policy = "auto" if device == "gpu" else "always"
        score, ok, params, _ = chip_smoke.run_example(
            fn, mt.Context(device), policy)
    finally:
        TRAINER.step, TRAINER._graph_step = STEP, GRAPH_STEP
        TRAINER.set_params = SET_PARAMS
    return {"score": score, "assert_held": ok, "params": params, "log": log}


def first_part(a, b):
    for i, (x, y) in enumerate(zip(a["log"], b["log"])):
        for u, v in zip(x["params"] + x["state"], y["params"] + y["state"]):
            if np.abs(u - v).max() > PART * max(np.abs(v).max(), 1e-30):
                return i
    return None


def compare(a, b):
    rel = chip_smoke._rel_norms(a["params"], b["params"])
    return {"first_step_apart": first_part(a, b),
            "steps": [len(a["log"]), len(b["log"])],
            "final_param_rel_err_max": max(rel.values())}


def main():
    if not torch.cuda.is_available():
        print("torch_fused_divergence: no CUDA device", file=sys.stderr)
        return 1
    for name, fn in chip_smoke.LOSS_EXAMPLES:
        runs = {"cpu": run(fn, "cpu"), "card": run(fn, "gpu"),
                "card_eager": run(fn, "gpu", eager=True),
                "cpu_recreate": run(fn, "cpu", recreate=True),
                "card_recreate": run(fn, "gpu", recreate=True)}
        out = {"example": name,
               "card_vs_cpu": compare(runs["card"], runs["cpu"]),
               "card_eager_vs_cpu": compare(runs["card_eager"], runs["cpu"]),
               "recreate_card_vs_cpu": compare(runs["card_recreate"],
                                               runs["cpu_recreate"]),
               "scores": {k: r["score"] for k, r in runs.items()},
               "asserts_held": {k: r["assert_held"]
                                for k, r in runs.items()}}
        print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
