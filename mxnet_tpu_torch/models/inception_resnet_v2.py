"""Inception-ResNet-v2 (Szegedy et al. 2016, "Inception-v4,
Inception-ResNet and the Impact of Residual Connections"); reference
``example/image-classification/symbols/inception-resnet-v2.py``.
299x299 input.  Residual inception blocks: each block's concat output
projects back to the trunk width and is added to the trunk with a
residual scale (0.1-0.2 per the paper) before the activation.

The same graph, argument and aux-state names and shapes as the JAX
package's ``mxnet_tpu/models/inception_resnet_v2.py``, so a checkpoint of
either package loads in the other.
"""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None,
          act=True):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    b = sym.BatchNorm(data=c, fix_gamma=True, eps=1e-3, name="%s_bn" % name)
    return sym.Activation(data=b, act_type="relu") if act else b


def _stem(data):
    net = _conv(data, 32, (3, 3), stride=(2, 2), name="stem1")
    net = _conv(net, 32, (3, 3), name="stem2")
    net = _conv(net, 64, (3, 3), pad=(1, 1), name="stem3")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = _conv(net, 80, (1, 1), name="stem4")
    net = _conv(net, 192, (3, 3), name="stem5")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    # mixed 5b: bring the trunk to 320 channels
    b1 = _conv(net, 96, (1, 1), name="m5b_1x1")
    b5 = _conv(net, 48, (1, 1), name="m5b_5x5r")
    b5 = _conv(b5, 64, (5, 5), pad=(2, 2), name="m5b_5x5")
    b3 = _conv(net, 64, (1, 1), name="m5b_3x3r")
    b3 = _conv(b3, 96, (3, 3), pad=(1, 1), name="m5b_3x3a")
    b3 = _conv(b3, 96, (3, 3), pad=(1, 1), name="m5b_3x3b")
    bp = sym.Pooling(net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = _conv(bp, 64, (1, 1), name="m5b_proj")
    return sym.Concat(b1, b5, b3, bp, name="mixed_5b")      # 320 ch


def _block35(net, idx, scale=0.17):
    """Inception-ResNet-A over the 35x35 trunk (320 ch)."""
    name = "b35_%d" % idx
    b1 = _conv(net, 32, (1, 1), name=name + "_1x1")
    b3 = _conv(net, 32, (1, 1), name=name + "_3x3r")
    b3 = _conv(b3, 32, (3, 3), pad=(1, 1), name=name + "_3x3")
    bd = _conv(net, 32, (1, 1), name=name + "_d3r")
    bd = _conv(bd, 48, (3, 3), pad=(1, 1), name=name + "_d3a")
    bd = _conv(bd, 64, (3, 3), pad=(1, 1), name=name + "_d3b")
    mix = sym.Concat(b1, b3, bd)
    up = _conv(mix, 320, (1, 1), name=name + "_up", act=False)
    return sym.Activation(net + up * scale, act_type="relu")


def _reduction_a(net):
    b3 = _conv(net, 384, (3, 3), stride=(2, 2), name="ra_3x3")
    bd = _conv(net, 256, (1, 1), name="ra_d3r")
    bd = _conv(bd, 256, (3, 3), pad=(1, 1), name="ra_d3a")
    bd = _conv(bd, 384, (3, 3), stride=(2, 2), name="ra_d3b")
    bp = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(b3, bd, bp, name="reduction_a")       # 1088 ch


def _block17(net, idx, scale=0.1):
    """Inception-ResNet-B over the 17x17 trunk (1088 ch)."""
    name = "b17_%d" % idx
    b1 = _conv(net, 192, (1, 1), name=name + "_1x1")
    b7 = _conv(net, 128, (1, 1), name=name + "_7r")
    b7 = _conv(b7, 160, (1, 7), pad=(0, 3), name=name + "_1x7")
    b7 = _conv(b7, 192, (7, 1), pad=(3, 0), name=name + "_7x1")
    mix = sym.Concat(b1, b7)
    up = _conv(mix, 1088, (1, 1), name=name + "_up", act=False)
    return sym.Activation(net + up * scale, act_type="relu")


def _reduction_b(net):
    ba = _conv(net, 256, (1, 1), name="rb_ar")
    ba = _conv(ba, 384, (3, 3), stride=(2, 2), name="rb_a")
    bb = _conv(net, 256, (1, 1), name="rb_br")
    bb = _conv(bb, 288, (3, 3), stride=(2, 2), name="rb_b")
    bc = _conv(net, 256, (1, 1), name="rb_cr")
    bc = _conv(bc, 288, (3, 3), pad=(1, 1), name="rb_ca")
    bc = _conv(bc, 320, (3, 3), stride=(2, 2), name="rb_cb")
    bp = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(ba, bb, bc, bp, name="reduction_b")   # 2080 ch


def _block8(net, idx, scale=0.2, act=True):
    """Inception-ResNet-C over the 8x8 trunk (2080 ch)."""
    name = "b8_%d" % idx
    b1 = _conv(net, 192, (1, 1), name=name + "_1x1")
    b3 = _conv(net, 192, (1, 1), name=name + "_3r")
    b3 = _conv(b3, 224, (1, 3), pad=(0, 1), name=name + "_1x3")
    b3 = _conv(b3, 256, (3, 1), pad=(1, 0), name=name + "_3x1")
    mix = sym.Concat(b1, b3)
    up = _conv(mix, 2080, (1, 1), name=name + "_up", act=False)
    out = net + up * scale
    return sym.Activation(out, act_type="relu") if act else out


def get_symbol(num_classes=1000, blocks=(10, 20, 10), **kwargs):
    """Build Inception-ResNet-v2.  ``blocks`` counts the A/B/C residual
    blocks; the default is the published 10/20/10 network (pass a
    smaller tuple, e.g. ``(5, 10, 5)``, for quick tests)."""
    data = sym.Variable("data")
    net = _stem(data)
    for i in range(blocks[0]):
        net = _block35(net, i)
    net = _reduction_a(net)
    for i in range(blocks[1]):
        net = _block17(net, i)
    net = _reduction_b(net)
    for i in range(blocks[2] - 1):
        net = _block8(net, i)
    net = _block8(net, blocks[2] - 1, scale=1.0, act=False)
    net = _conv(net, 1536, (1, 1), name="conv_final")
    net = sym.Pooling(net, kernel=(8, 8), stride=(1, 1), pool_type="avg",
                      global_pool=True)
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.2)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
