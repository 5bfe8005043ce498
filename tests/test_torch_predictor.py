"""The port's Predictor against ``mxnet_tpu``'s on a tiny transformer LM
checkpoint that ``mxnet_tpu`` saved; symbol JSON and ``.params`` files
shared by both packages."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.predictor
from mxnet_tpu.models import transformer as jax_transformer

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import transformer as torch_transformer
from mxnet_tpu_torch.serving import CompiledForward

TINY = dict(seq_len=32, num_hidden=64, num_heads=4, num_layers=2,
            vocab_size=97)
GPT2_SMALL = dict(seq_len=1024, num_hidden=768, num_heads=12, num_layers=12,
                  vocab_size=50257)
BATCH = 2
# float32 on both sides through two blocks; matrix products and softmax
# sums in another order: logits of magnitude ~2 agree to ~1e-6
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PROB_TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_symbol(**kw):
    with mx.name.NameManager():
        return jax_transformer.get_symbol(**kw)


def _torch_symbol(**kw):
    with mt.name.NameManager():
        return torch_transformer.get_symbol(**kw)


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """A tiny LM checkpoint saved by mxnet_tpu, token ids (two out of
    range, which both packages clamp), and mxnet_tpu's outputs."""
    rng = np.random.RandomState(0)
    symbol = _jax_symbol(**TINY)
    shapes, _, _ = symbol.infer_shape(data=(BATCH, 32),
                                      softmax_label=(BATCH, 32))
    params = {n: rng.normal(0, 0.2, s).astype(np.float32)
              for n, s in zip(symbol.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    prefix = os.path.join(str(tmp_path_factory.mktemp("lm")), "lm")
    mx.model.save_checkpoint(prefix, 0, symbol,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    ids = rng.randint(0, TINY["vocab_size"], (BATCH, 32))
    ids[0, :2] = (500, -7)
    # mxnet_tpu's shape inference needs the label's shape declared: it
    # cannot reach the label through its Reshape from the data alone
    jpred = mx.predictor.Predictor.from_checkpoint(
        prefix, 0, {"data": (BATCH, 32), "softmax_label": (BATCH, 32)})
    probs = jpred.predict(data=ids, softmax_label=np.zeros((BATCH, 32)))[0]
    head = symbol.get_internals()["head_output"]
    with open(prefix + "-0000.params", "rb") as f:
        blob = f.read()
    logits = mx.predictor.Predictor(head.tojson(), blob,
                                    {"data": (BATCH, 32)}).predict(data=ids)[0]
    return dict(prefix=prefix, params=params, blob=blob, ids=ids,
                head_json=head.tojson(), probs=np.asarray(probs),
                logits=np.asarray(logits))


def test_predictor_matches_mxnet_tpu(lm):
    pred = mt.Predictor.from_checkpoint(lm["prefix"], 0,
                                        {"data": (BATCH, 32)}, dev_type="cpu")
    assert pred.input_dtype("data") == torch.int32
    (probs,) = pred.predict(data=lm["ids"])
    assert probs.shape == (BATCH * 32, TINY["vocab_size"])
    np.testing.assert_allclose(probs.numpy(), lm["probs"], **PROB_TOL)
    head = mt.Predictor(lm["head_json"], lm["blob"], {"data": (BATCH, 32)},
                        dev_type=1)    # the reference's id for the cpu
    np.testing.assert_allclose(head.predict(data=lm["ids"])[0].numpy(),
                               lm["logits"], **LOGIT_TOL)


def test_converted_params_match_mxnet_tpu(lm):
    args, aux = mt.convert.params_from_mxnet_tpu(
        {k: mx.nd.array(v).asnumpy() for k, v in lm["params"].items()}, {},
        device="cpu")
    internals = mt.symbol.load_json(lm["head_json"])
    cf = CompiledForward(internals, ["data"])
    assert set(cf.param_names) == set(args)
    (logits,) = cf.run(args, aux,
                       {"data": torch.from_numpy(lm["ids"]).int()})
    np.testing.assert_allclose(logits.numpy(), lm["logits"], **LOGIT_TOL)


def test_convert_keeps_bf16():
    bits = mx.nd.array(np.linspace(-2, 2, 12).reshape(3, 4),
                       dtype="bfloat16").asnumpy()
    args, _ = mt.convert.params_from_mxnet_tpu({"w": bits}, {})
    assert args["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(args["w"].float().numpy(),
                                  bits.astype(np.float32))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_symbol_json_round_trips(direction):
    jtext = _jax_symbol(**TINY).tojson()
    ttext = _torch_symbol(**TINY).tojson()
    assert jtext == ttext
    if direction == "jax_to_torch":
        assert mt.symbol.load_json(jtext).tojson() == jtext
    else:
        assert mx.symbol.load_json(ttext).tojson() == ttext


def test_infer_shape_agrees_at_gpt2_small_widths():
    """Shapes only: no weights of this size are made."""
    shapes = dict(data=(4, 1024), softmax_label=(4, 1024))
    jsym, tsym = _jax_symbol(**GPT2_SMALL), _torch_symbol(**GPT2_SMALL)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    assert tsym.infer_type(data="int32")[1] == [torch.float32]


def test_params_file_round_trips_between_packages(tmp_path):
    rng = np.random.RandomState(1)
    tensors = {"arg:w": torch.from_numpy(rng.normal(0, 1, (3, 5))).float(),
               "arg:h": torch.from_numpy(rng.normal(0, 1, (2, 4)))
               .to(torch.bfloat16),
               "aux:n": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    mt.nd.save(str(tmp_path / "t.params"), tensors)
    loaded = mx.nd.load(str(tmp_path / "t.params"))
    for k, v in tensors.items():
        np.testing.assert_array_equal(
            np.asarray(loaded[k].asnumpy(), np.float32), v.float().numpy())
    mx.nd.save(str(tmp_path / "j.params"), loaded)
    back = mt.nd.load(str(tmp_path / "j.params"))
    for k, v in tensors.items():
        assert isinstance(back[k], mt.nd.NDArray)
        assert back[k].dtype == v.dtype and torch.equal(back[k].data, v)
