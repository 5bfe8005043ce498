"""GoogLeNet / Inception v1 (Szegedy et al. 2014).

Parity with the reference's ``example/image-classification/symbols/
googlenet.py`` (the original 22-layer inception network with 1x1 / 3x3 /
5x5 / pool-projection branches).

The same graph, argument and aux-state names and shapes as the JAX
package's ``mxnet_tpu/models/googlenet.py``, so a checkpoint of either
package loads in the other.
"""
from .. import symbol as sym


def _conv_relu(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0)):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="conv_" + name)
    return sym.Activation(data=c, act_type="relu", name="relu_" + name)


def inception_unit(data, f1x1, f3x3r, f3x3, f5x5r, f5x5, fpool, name):
    """One inception block: four parallel branches concatenated on the
    channel axis."""
    b1 = _conv_relu(data, f1x1, (1, 1), name + "_1x1")
    b2 = _conv_relu(data, f3x3r, (1, 1), name + "_3x3r")
    b2 = _conv_relu(b2, f3x3, (3, 3), name + "_3x3", pad=(1, 1))
    b3 = _conv_relu(data, f5x5r, (1, 1), name + "_5x5r")
    b3 = _conv_relu(b3, f5x5, (5, 5), name + "_5x5", pad=(2, 2))
    b4 = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max", name=name + "_pool")
    b4 = _conv_relu(b4, fpool, (1, 1), name + "_proj")
    return sym.Concat(b1, b2, b3, b4, num_args=4, dim=1,
                      name=name + "_concat")


# per-stage branch widths of the published architecture
_STAGE3 = [("3a", 64, 96, 128, 16, 32, 32), ("3b", 128, 128, 192, 32, 96, 64)]
_STAGE4 = [("4a", 192, 96, 208, 16, 48, 64),
           ("4b", 160, 112, 224, 24, 64, 64),
           ("4c", 128, 128, 256, 24, 64, 64),
           ("4d", 112, 144, 288, 32, 64, 64),
           ("4e", 256, 160, 320, 32, 128, 128)]
_STAGE5 = [("5a", 256, 160, 320, 32, 128, 128),
           ("5b", 384, 192, 384, 48, 128, 128)]


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    net = _conv_relu(data, 64, (7, 7), "1", stride=(2, 2), pad=(3, 3))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _conv_relu(net, 64, (1, 1), "2r")
    net = _conv_relu(net, 192, (3, 3), "2", pad=(1, 1))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    for stage, pool_after in ((_STAGE3, True), (_STAGE4, True),
                              (_STAGE5, False)):
        for args in stage:
            net = inception_unit(net, *args[1:], name="in" + args[0])
        if pool_after:
            net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), pool_type="max")
    net = sym.Pooling(data=net, kernel=(7, 7), global_pool=True,
                      pool_type="avg")
    net = sym.Flatten(data=net)
    net = sym.Dropout(data=net, p=0.4)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
