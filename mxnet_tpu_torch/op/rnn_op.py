"""Fused ``RNN`` operator (``mxnet_tpu/op/rnn_op.py``).

The input projection of every time step is one ``[T*N, I] x [I, G*H]``
product per layer and direction; only the recurrent half runs step by
step, in a Python loop over plain PyTorch ops, as the JAX package's
``lax.scan`` does.  No cuDNN RNN: its parameter layout and rounding are
not the JAX package's.

Packed parameter layout, shared with the JAX package so one vector means
the same in both: for each layer then each direction ``i2h_weight`` then
``h2h_weight`` (row-major), then for each layer and direction ``i2h_bias``
then ``h2h_bias``.  Gate order: LSTM ``[i, f, c, o]``, GRU ``[r, z, n]``
(reset applied to the h2h branch, cuDNN's convention), vanilla ``[h]``.
"""
from __future__ import annotations

import torch

from .registry import Param, register, get

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total packed parameter count (the analog of cudnnGetRNNParamsSize)."""
    G = _GATES[mode]
    D = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * D
        size += D * G * state_size * (in_sz + state_size + 2)
    return size


def _unpack(params, mode, input_size, H, L, D):
    """Split the flat parameter vector into per-(layer, direction)
    ``[i2h_weight, h2h_weight, i2h_bias, h2h_bias]`` views."""
    G = _GATES[mode]
    ws, off = [], 0

    def take(n, shape):
        nonlocal off
        w = params.narrow(0, off, n).reshape(shape)
        off += n
        return w

    for layer in range(L):
        in_sz = input_size if layer == 0 else H * D
        ws.append([[take(G * H * in_sz, (G * H, in_sz)),
                    take(G * H * H, (G * H, H)), None, None]
                   for _ in range(D)])
    for layer in range(L):
        for d in range(D):
            ws[layer][d][2] = take(G * H, (G * H,))
            ws[layer][d][3] = take(G * H, (G * H,))
    return ws


def _cell_scan(mode, x_proj, wh, bh, h0, c0, reverse, clip=None):
    """The recurrent half over time.  ``x_proj`` (T, N, G*H) already holds
    ``x @ i2h_weight.T + i2h_bias`` for every step.  ``clip=(min, max)``
    bounds the LSTM cell state (lstm_state_clip_min/max).  Returns the
    per-step outputs (T, N, H), the last h and (LSTM) the last c."""
    steps = range(x_proj.shape[0] - 1, -1, -1) if reverse \
        else range(x_proj.shape[0])
    out = [None] * x_proj.shape[0]
    h, cc = h0, c0
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    for t in steps:
        xp = x_proj[t]
        if mode == "lstm":
            i, f, g, o = (xp + h @ wh.T + bh).chunk(4, dim=-1)
            cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
            if clip is not None:
                cc = cc.clamp(clip[0], clip[1])
            h = torch.sigmoid(o) * torch.tanh(cc)
        elif mode == "gru":
            xr, xz, xn = xp.chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        else:
            h = act(xp + h @ wh.T + bh)
        out[t] = h
    return torch.stack(out, 0), h, cc


@register("RNN",
          params_spec=(Param("state_size", int, required=True),
                       Param("num_layers", int, required=True),
                       Param("mode", str, required=True,
                             enum=("rnn_relu", "rnn_tanh", "lstm", "gru")),
                       Param("bidirectional", bool, False),
                       Param("p", float, 0.0),
                       Param("state_outputs", bool, False),
                       Param("lstm_state_clip_min", float, 0.0),
                       Param("lstm_state_clip_max", float, 0.0)),
          input_names=lambda p: (["data", "parameters", "state", "state_cell"]
                                 if p.get("mode") == "lstm"
                                 else ["data", "parameters", "state"]),
          num_outputs=lambda p: ((3 if p.get("mode") == "lstm" else 2)
                                 if p.get("state_outputs") else 1),
          output_names=lambda p: ((["output", "state", "state_cell"]
                                   if p.get("mode") == "lstm"
                                   else ["output", "state"])
                                  if p.get("state_outputs") else ["output"]),
          uses_rng=True, rng_in_eval=False, mode_dependent=True,
          hint="rnn")
def _rnn(p, c, data, parameters, state, state_cell=None):
    """data (T, N, input_size), time-major; state (L*D, N, H).  In
    training with ``p > 0`` each layer's output but the last goes through
    inverted dropout, its mask drawn from the OpContext's generator."""
    mode = p["mode"]
    H = p["state_size"]
    L = p["num_layers"]
    D = 2 if p["bidirectional"] else 1
    T, N, I = data.shape
    ws = _unpack(parameters.reshape(-1), mode, I, H, L, D)
    clip = None
    if mode == "lstm" and (p["lstm_state_clip_min"] != 0.0
                           or p["lstm_state_clip_max"] != 0.0):
        clip = (p["lstm_state_clip_min"], p["lstm_state_clip_max"])

    x = data
    h_out, c_out = [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            wi, wh, bi, bh = ws[layer][d]
            idx = layer * D + d
            c0 = state_cell[idx] if mode == "lstm" else None
            x_proj = (x.reshape(T * N, -1) @ wi.T + bi).reshape(T, N, -1)
            out, hT, cT = _cell_scan(mode, x_proj, wh, bh, state[idx], c0,
                                     reverse=(d == 1), clip=clip)
            outs.append(out)
            h_out.append(hT)
            if mode == "lstm":
                c_out.append(cT)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p["p"] > 0 and c.is_train and layer != L - 1:
            keep = 1.0 - p["p"]
            mask = torch.empty(x.shape, dtype=torch.float32,
                               device=x.device).bernoulli_(keep,
                                                           generator=c.rng)
            keep = torch.full((), keep, dtype=x.dtype, device=x.device)
            x = torch.where(mask != 0, x / keep, 0.0)
    if not p["state_outputs"]:
        return x
    hN = torch.stack(h_out, 0)
    if mode == "lstm":
        return x, hN, torch.stack(c_out, 0)
    return x, hN


def _rnn_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return None
    T, N, I = d
    H, L = p["state_size"], p["num_layers"]
    D = 2 if p["bidirectional"] else 1
    psize = rnn_param_size(p["mode"], I, H, L, p["bidirectional"])
    ins = [tuple(d), (psize,), (L * D, N, H)]
    if p["mode"] == "lstm":
        ins.append((L * D, N, H))
    outs = [(T, N, H * D)]
    if p["state_outputs"]:
        outs.append((L * D, N, H))
        if p["mode"] == "lstm":
            outs.append((L * D, N, H))
    return ins, outs, []


get("RNN").infer_shape = _rnn_infer_shape
