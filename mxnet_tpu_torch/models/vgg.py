"""VGG 11/13/16/19 (Simonyan & Zisserman 2014); reference
``example/image-classification/symbols/vgg.py``.

The same graph, argument and aux-state names and shapes as the JAX
package's ``mxnet_tpu/models/vgg.py``, so a checkpoint of either package
loads in the other."""
from .. import symbol as sym

# filters per stage, convs per stage
_CONFIGS = {
    11: ([64, 128, 256, 512, 512], [1, 1, 2, 2, 2]),
    13: ([64, 128, 256, 512, 512], [2, 2, 2, 2, 2]),
    16: ([64, 128, 256, 512, 512], [2, 2, 3, 3, 3]),
    19: ([64, 128, 256, 512, 512], [2, 2, 4, 4, 4]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in _CONFIGS:
        raise ValueError("vgg depth must be one of %s" % sorted(_CONFIGS))
    filters, convs = _CONFIGS[num_layers]
    net = sym.Variable("data")
    for i, (nf, nc) in enumerate(zip(filters, convs)):
        for j in range(nc):
            net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=nf,
                                  name="conv%d_%d" % (i + 1, j + 1))
            if batch_norm:
                net = sym.BatchNorm(data=net, name="bn%d_%d" % (i + 1, j + 1))
            net = sym.Activation(data=net, act_type="relu")
        net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2))
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc6")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc7")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=net, name="softmax")
