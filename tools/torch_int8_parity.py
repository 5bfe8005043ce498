"""Where the int8 serving tenants' card-to-CPU gap comes from.

``chip_smoke.py`` serve_int8 holds the int8 tenants' rows on the card
against the port's forward of the same quantized symbol and weights on
the CPU, within SERVE_INT8_TOL of the largest reference value.  This
script reads that gap on ResNet-50 (and GPT-2 small) under variants that
take one source of difference away at a time, and under planted faults
that a broken int8 path would give, so that the tolerance can be set
between the two:

- ``float32``: the float tenant, no quantization (the convolutions'
  algorithms and sums alone);
- ``weights_bfloat16``: int8 weights, bfloat16 compute, no activation
  quantization (``quantize_model``);
- ``calibrated_float32``: int8 weights and calibrated activation
  quantization in float32 compute (``calibrate_model``);
- ``calibrated_bfloat16``: the served tenant (``chip_smoke.int8_tenants``);
- ``fault_no_dequantize``: the served tenant on the card with one
  mid-network weight's scales set to 1 (a dequantize left out), against
  the sound tenant on the CPU, as are the other faults;
- ``fault_weight_scale_x2``: one mid-network weight's scales doubled
  (a wrong weight scale);
- ``fault_act_scale_x2``: one mid-network activation's scale doubled
  (a coarser activation grid than calibrated; ResNet-50 only).

For the served ResNet-50 tenant it also gives the gap at each residual
unit's output (``plusN``), from the stem to the softmax.  Every forward
is eager (``serving.CompiledForward``), the card's and the CPU's on the
same rows.

Run on a machine with a CUDA card, from the repo root:

    python3 tools/torch_int8_parity.py [--rows 4] [--gpt2-rows 2]

It prints one JSON line a reading and a summary line last.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from chip_smoke import mt  # noqa: E402

CPU = torch.device("cpu")


def _labels(sym, x):
    """Zero labels for the symbol's label inputs: (n,) for an image
    batch, (n, t) for token rows."""
    shape = tuple(x.shape[:2]) if x.dim() == 2 else tuple(x.shape[:1])
    return {n: torch.zeros(shape) for n in sym.list_arguments()
            if n.endswith("label")}


def forward(sym, arg, aux, x, device):
    """The eager forward of ``sym`` on ``device``: (outputs, seconds)."""
    labels = _labels(sym, x)
    dtypes = mt.serving.compiled.infer_input_dtypes(
        sym, arg, ["data"] + list(labels))
    feed = dict({n: v.to(device) for n, v in labels.items()},
                data=x.to(dtypes["data"]).to(device))
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = mt.serving.CompiledForward(sym, list(feed)).run(
            {k: v.to(device) for k, v in arg.items()},
            {k: v.to(device) for k, v in aux.items()}, feed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return [o.float().cpu() for o in outs], time.perf_counter() - t0


def gap_record(name, variant, sym, arg, aux, x, ref_top=None,
               card_arg=None):
    """One variant's reading: the card against the CPU on rows ``x``
    (the card with ``card_arg`` where it is given: a planted fault read
    against the sound model on the CPU)."""
    (got,), card_s = forward(sym, arg if card_arg is None else card_arg,
                             aux, x, torch.device("cuda"))
    (want,), cpu_s = forward(sym, arg, aux, x, CPU)
    rec = {"tenant": name, "variant": variant, "rows": len(x),
           "max_rel_gap_cpu": cs._rel_gap(got, want),
           "max_abs_gap": float((got - want).abs().max()),
           "largest_value": float(want.abs().max()),
           "top1_card_vs_cpu": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
           "card_s": card_s, "cpu_s": cpu_s}
    if ref_top is not None:
        rec["top1_vs_float32"] = float((got.argmax(-1) == ref_top)
                                       .float().mean())
    print(json.dumps(rec), flush=True)
    return rec, got


FAULTS = {"fault_no_dequantize": torch.ones_like,
          "fault_weight_scale_x2": lambda s: 2 * s,
          "fault_act_scale_x2": lambda s: 2 * s}


def planted(arg, key, how):
    """``arg`` with the scale ``key`` broken as FAULTS[``how``] says."""
    return dict(arg, **{key: FAULTS[how](arg[key])})


def mid_scale(arg, act):
    """The middle one, by name, of the activation (``act``) or weight
    scales."""
    keys = sorted(k for k in arg if k.endswith("_quant_scale")
                  and ("_act_" in k) == act)
    return keys[len(keys) // 2]


def faults(name, sym, arg, aux, x, ref_top, kinds):
    """The planted faults' readings on the served tenant."""
    out = []
    for how in kinds:
        key = mid_scale(arg, "_act_" in how)
        rec = gap_record(name, how, sym, arg, aux, x, ref_top,
                         card_arg=planted(arg, key, how))[0]
        rec["scale"] = key
        out.append(rec)
    return out


def by_unit(sym, arg, aux, x):
    """The served tenant's gap at each residual unit's output."""
    inner = sym.get_internals()
    names = [n for n in inner.list_outputs()
             if n.startswith(("pooling0_", "plus", "fc1_output"))]
    group = mt.sym.Group([inner[n] for n in names])
    got, _ = forward(group, arg, aux, x, torch.device("cuda"))
    want, _ = forward(group, arg, aux, x, CPU)
    rows = [{"output": n, "max_rel_gap_cpu": cs._rel_gap(g, w)}
            for n, g, w in zip(names, got, want)]
    print(json.dumps({"by_unit": rows}), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4,
                    help="ResNet-50 rows a reading")
    ap.add_argument("--gpt2-rows", type=int, default=2,
                    help="GPT-2 small rows a reading (0: none)")
    args = ap.parse_args()
    card = cs.environment()
    cs.build_kernels()
    tenants = cs.serve_tenants()
    served, _ = cs.int8_tenants(tenants)
    rng = np.random.default_rng(cs.SEED + 9)
    summary = {"card": card}

    # ResNet-50
    rsym, rarg, raux, image, rmake = tenants["resnet-50"]
    x = rmake(rng, args.rows)
    rec, ref = gap_record("resnet-50", "float32", rsym, rarg, raux, x)
    ref_top = ref.argmax(-1)
    readings = [rec]
    nd = cs._nd
    with mt.gpu(0):
        wsym, warg, _ = mt.contrib.quantization.quantize_model(
            rsym, nd(rarg), compute_dtype="bfloat16")
    readings.append(gap_record(
        "resnet-50", "weights_bfloat16", wsym,
        cs._to_bf16({k: v.data for k, v in warg.items()}),
        cs._to_bf16(raux), x, ref_top)[0])
    calib = np.random.default_rng(cs.SEED + 7).standard_normal(
        (cs.SERVE_CALIBRATION,) + image, dtype=np.float32)
    with mt.gpu(0):
        it = mt.io.NDArrayIter({"data": calib}, None, cs.SERVE_CALIBRATION)
        fsym, farg, faux, cal = mt.contrib.quantization.calibrate_model(
            rsym, nd(rarg), nd(raux), calib_iter=it,
            calib_mode="percentile", percentile=cs.SERVE_INT8_PERCENTILE,
            compute_dtype="float32", ctx=mt.gpu(0))
    readings.append(gap_record(
        "resnet-50", "calibrated_float32", fsym,
        {k: v.data for k, v in farg.items()},
        {k: v.data for k, v in faux.items()}, x, ref_top)[0])
    qsym, qarg, qaux, _, _ = served["resnet-50"]
    readings.append(gap_record("resnet-50", "calibrated_bfloat16", qsym,
                               qarg, qaux, x, ref_top)[0])
    readings += faults("resnet-50", qsym, qarg, qaux, x, ref_top,
                       sorted(FAULTS))
    summary["resnet-50"] = {r["variant"]: r["max_rel_gap_cpu"]
                            for r in readings}
    summary["resnet-50_by_unit"] = by_unit(qsym, qarg, qaux, x)

    # GPT-2 small, weights only (as served)
    if args.gpt2_rows:
        lsym, larg, _, _, lmake = tenants["gpt2-small"]
        x = lmake(rng, args.gpt2_rows)
        (ref,), _ = forward(lsym, larg, {}, x, torch.device("cuda"))
        ref_top = ref.argmax(-1)
        qsym, qarg, _, _, _ = served["gpt2-small"]
        readings = [gap_record("gpt2-small", "weights_bfloat16", qsym, qarg,
                               {}, x, ref_top)[0]]
        readings += faults("gpt2-small", qsym, qarg, {}, x, ref_top,
                           ["fault_no_dequantize", "fault_weight_scale_x2"])
        summary["gpt2-small"] = {r["variant"]: r["max_rel_gap_cpu"]
                                 for r in readings}
    print(json.dumps({"int8_parity": summary}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
