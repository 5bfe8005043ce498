"""Inception-BN (GoogLeNet v2, Ioffe & Szegedy 2015); reference
``example/image-classification/symbols/inception-bn.py``.

The same graph, argument and aux-state names and shapes as the JAX
package's ``mxnet_tpu/models/inception_bn.py``, so a checkpoint of either
package loads in the other."""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    b = sym.BatchNorm(data=c, fix_gamma=False, name="%s_bn" % name)
    return sym.Activation(data=b, act_type="relu")


def _inception(data, f1, f3r, f3, d3r, d3, proj, pool_type, name,
               stride=(1, 1)):
    parts = []
    if f1 > 0:
        parts.append(_conv(data, f1, (1, 1), name=name + "_1x1"))
    r3 = _conv(data, f3r, (1, 1), name=name + "_3x3r")
    parts.append(_conv(r3, f3, (3, 3), stride=stride, pad=(1, 1),
                       name=name + "_3x3"))
    rd = _conv(data, d3r, (1, 1), name=name + "_d3x3r")
    rd = _conv(rd, d3, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    parts.append(_conv(rd, d3, (3, 3), stride=stride, pad=(1, 1),
                       name=name + "_d3x3b"))
    pool = sym.Pooling(data=data, kernel=(3, 3), stride=stride, pad=(1, 1),
                       pool_type=pool_type)
    if proj > 0:
        pool = _conv(pool, proj, (1, 1), name=name + "_proj")
    parts.append(pool)
    return sym.Concat(*parts, name=name + "_concat")


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    net = _conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="conv1")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _conv(net, 64, (1, 1), name="conv2red")
    net = _conv(net, 192, (3, 3), pad=(1, 1), name="conv2")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _inception(net, 64, 64, 64, 64, 96, 32, "avg", "in3a")
    net = _inception(net, 64, 64, 96, 64, 96, 64, "avg", "in3b")
    net = _inception(net, 0, 128, 160, 64, 96, 0, "max", "in3c",
                     stride=(2, 2))
    net = _inception(net, 224, 64, 96, 96, 128, 128, "avg", "in4a")
    net = _inception(net, 192, 96, 128, 96, 128, 128, "avg", "in4b")
    net = _inception(net, 160, 128, 160, 128, 160, 128, "avg", "in4c")
    net = _inception(net, 96, 128, 192, 160, 192, 128, "avg", "in4d")
    net = _inception(net, 0, 128, 192, 192, 256, 0, "max", "in4e",
                     stride=(2, 2))
    net = _inception(net, 352, 192, 320, 160, 224, 128, "avg", "in5a")
    net = _inception(net, 352, 192, 320, 192, 224, 128, "max", "in5b")
    net = sym.Pooling(data=net, global_pool=True, kernel=(7, 7),
                      pool_type="avg")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
