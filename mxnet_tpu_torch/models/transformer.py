"""Decoder-only transformer language model (GPT-style):
``mxnet_tpu/models/transformer.py`` with the same graph and the same
parameter names, so a checkpoint of either package loads in the other.

Pre-norm blocks: x + Attn(LN(x)), x + MLP(LN(x)); learned positional
embeddings; an untied output head.  The attention core is
``_contrib_DotProductAttention``, which runs the flash-attention CUDA
kernel on the card.
"""
from .. import symbol as sym

__all__ = ["get_symbol"]


def _attention(x, seq_len, num_hidden, num_heads, prefix, causal=True):
    """Multi-head self-attention over (B*T, C) flattened input; returns
    (B*T, C)."""
    head_dim = num_hidden // num_heads
    qkv = sym.FullyConnected(x, num_hidden=3 * num_hidden,
                             name=prefix + "qkv")
    qkv = sym.Reshape(qkv, shape=(-1, seq_len, 3, num_heads, head_dim))
    q = sym.Reshape(sym.slice_axis(qkv, axis=2, begin=0, end=1),
                    shape=(-1, seq_len, num_heads, head_dim))
    k = sym.Reshape(sym.slice_axis(qkv, axis=2, begin=1, end=2),
                    shape=(-1, seq_len, num_heads, head_dim))
    v = sym.Reshape(sym.slice_axis(qkv, axis=2, begin=2, end=3),
                    shape=(-1, seq_len, num_heads, head_dim))
    # [b, t, h, d] strided views of qkv -> the flash-attention kernel
    out = sym._contrib_DotProductAttention(q, k, v, causal=causal,
                                           name=prefix + "attn")
    out = sym.Reshape(out, shape=(-1, num_hidden))
    return sym.FullyConnected(out, num_hidden=num_hidden,
                              name=prefix + "proj")


def _block(x, seq_len, num_hidden, num_heads, prefix):
    ln1 = sym.LayerNorm(x, name=prefix + "ln1")
    x = x + _attention(ln1, seq_len, num_hidden, num_heads,
                       prefix + "attn_")
    ln2 = sym.LayerNorm(x, name=prefix + "ln2")
    h = sym.FullyConnected(ln2, num_hidden=4 * num_hidden,
                           name=prefix + "mlp1")
    h = sym.Activation(h, act_type="gelu")
    h = sym.FullyConnected(h, num_hidden=num_hidden, name=prefix + "mlp2")
    return x + h


def get_symbol(seq_len=128, num_classes=1000, num_hidden=256, num_heads=4,
               num_layers=2, dropout=0.0, **kwargs):
    """Build the LM symbol: data (B, T) int tokens -> softmax over vocab
    at every position, label (B, T)."""
    vocab = kwargs.get("vocab_size", num_classes)
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    tok = sym.Embedding(data, input_dim=vocab, output_dim=num_hidden,
                        name="tok_embed")
    pos_idx = sym._arange(start=0, stop=seq_len, name="pos_idx")
    pos = sym.Embedding(pos_idx, input_dim=seq_len, output_dim=num_hidden,
                        name="pos_embed")
    x = sym.broadcast_add(tok, sym.Reshape(pos, shape=(1, seq_len,
                                                       num_hidden)))
    x = sym.Reshape(x, shape=(-1, num_hidden))
    for i in range(num_layers):
        x = _block(x, seq_len, num_hidden, num_heads, "l%d_" % i)
        if dropout > 0:
            x = sym.Dropout(x, p=dropout)
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab, name="head")
    label = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label, name="softmax")
