"""Inception-v3 (Szegedy et al. 2015, "Rethinking the Inception
Architecture"); reference
``example/image-classification/symbols/inception-v3.py``.  299x299 input.

The same graph, argument and aux-state names and shapes as the JAX
package's ``mxnet_tpu/models/inception_v3.py``, so a checkpoint of either
package loads in the other."""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    b = sym.BatchNorm(data=c, fix_gamma=True, eps=1e-3, name="%s_bn" % name)
    return sym.Activation(data=b, act_type="relu")


def _pool(data, kernel, stride, pad, pool_type):
    return sym.Pooling(data=data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type)


def _inception_a(net, pool_proj, name):
    b1 = _conv(net, 64, (1, 1), name=name + "_1x1")
    b5 = _conv(net, 48, (1, 1), name=name + "_5x5r")
    b5 = _conv(b5, 64, (5, 5), pad=(2, 2), name=name + "_5x5")
    b3 = _conv(net, 64, (1, 1), name=name + "_3x3r")
    b3 = _conv(b3, 96, (3, 3), pad=(1, 1), name=name + "_3x3a")
    b3 = _conv(b3, 96, (3, 3), pad=(1, 1), name=name + "_3x3b")
    bp = _pool(net, (3, 3), (1, 1), (1, 1), "avg")
    bp = _conv(bp, pool_proj, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b5, b3, bp, name=name)


def _reduction_a(net, name):
    b3 = _conv(net, 384, (3, 3), stride=(2, 2), name=name + "_3x3")
    bd = _conv(net, 64, (1, 1), name=name + "_d3x3r")
    bd = _conv(bd, 96, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    bd = _conv(bd, 96, (3, 3), stride=(2, 2), name=name + "_d3x3b")
    bp = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    return sym.Concat(b3, bd, bp, name=name)


def _inception_b(net, n7, name):
    b1 = _conv(net, 192, (1, 1), name=name + "_1x1")
    b7 = _conv(net, n7, (1, 1), name=name + "_7x7r")
    b7 = _conv(b7, n7, (1, 7), pad=(0, 3), name=name + "_1x7a")
    b7 = _conv(b7, 192, (7, 1), pad=(3, 0), name=name + "_7x1a")
    bd = _conv(net, n7, (1, 1), name=name + "_d7r")
    bd = _conv(bd, n7, (7, 1), pad=(3, 0), name=name + "_d7x1a")
    bd = _conv(bd, n7, (1, 7), pad=(0, 3), name=name + "_d1x7a")
    bd = _conv(bd, n7, (7, 1), pad=(3, 0), name=name + "_d7x1b")
    bd = _conv(bd, 192, (1, 7), pad=(0, 3), name=name + "_d1x7b")
    bp = _pool(net, (3, 3), (1, 1), (1, 1), "avg")
    bp = _conv(bp, 192, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b7, bd, bp, name=name)


def _reduction_b(net, name):
    b3 = _conv(net, 192, (1, 1), name=name + "_3x3r")
    b3 = _conv(b3, 320, (3, 3), stride=(2, 2), name=name + "_3x3")
    b7 = _conv(net, 192, (1, 1), name=name + "_7x7r")
    b7 = _conv(b7, 192, (1, 7), pad=(0, 3), name=name + "_1x7")
    b7 = _conv(b7, 192, (7, 1), pad=(3, 0), name=name + "_7x1")
    b7 = _conv(b7, 192, (3, 3), stride=(2, 2), name=name + "_3x3b")
    bp = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    return sym.Concat(b3, b7, bp, name=name)


def _inception_c(net, name):
    b1 = _conv(net, 320, (1, 1), name=name + "_1x1")
    b3 = _conv(net, 384, (1, 1), name=name + "_3x3r")
    b3a = _conv(b3, 384, (1, 3), pad=(0, 1), name=name + "_1x3")
    b3b = _conv(b3, 384, (3, 1), pad=(1, 0), name=name + "_3x1")
    bd = _conv(net, 448, (1, 1), name=name + "_dr")
    bd = _conv(bd, 384, (3, 3), pad=(1, 1), name=name + "_d3x3")
    bda = _conv(bd, 384, (1, 3), pad=(0, 1), name=name + "_d1x3")
    bdb = _conv(bd, 384, (3, 1), pad=(1, 0), name=name + "_d3x1")
    bp = _pool(net, (3, 3), (1, 1), (1, 1), "avg")
    bp = _conv(bp, 192, (1, 1), name=name + "_proj")
    return sym.Concat(b1, b3a, b3b, bda, bdb, bp, name=name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    net = _conv(data, 32, (3, 3), stride=(2, 2), name="conv0")
    net = _conv(net, 32, (3, 3), name="conv1")
    net = _conv(net, 64, (3, 3), pad=(1, 1), name="conv2")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    net = _conv(net, 80, (1, 1), name="conv3")
    net = _conv(net, 192, (3, 3), name="conv4")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    net = _inception_a(net, 32, "mixed0")
    net = _inception_a(net, 64, "mixed1")
    net = _inception_a(net, 64, "mixed2")
    net = _reduction_a(net, "mixed3")
    net = _inception_b(net, 128, "mixed4")
    net = _inception_b(net, 160, "mixed5")
    net = _inception_b(net, 160, "mixed6")
    net = _inception_b(net, 192, "mixed7")
    net = _reduction_b(net, "mixed8")
    net = _inception_c(net, "mixed9")
    net = _inception_c(net, "mixed10")
    net = sym.Pooling(data=net, global_pool=True, kernel=(8, 8),
                      pool_type="avg")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
