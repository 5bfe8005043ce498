"""ResNeXt (Xie et al. 2016): aggregated-transform residual networks.

``mxnet_tpu/models/resnext.py``, after the reference's
``example/image-classification/symbols/resnext.py``: the bottleneck's 3x3
conv becomes a grouped convolution with ``num_group`` (cardinality)
parallel paths (cuDNN's grouped convolution on the card).  The same graph
and the same argument and aux-state names and shapes as the JAX
package's, so a checkpoint of either package loads in the other.
"""
from .. import symbol as sym

_UNITS = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def _bn(net, name):
    return sym.BatchNorm(data=net, fix_gamma=False, eps=2e-5,
                         momentum=0.9, name=name)


def resnext_unit(data, num_filter, stride, dim_match, name, num_group,
                 bottleneck_width):
    """One aggregated bottleneck: 1x1 reduce -> grouped 3x3 -> 1x1
    expand, plus identity/projection shortcut."""
    mid = num_filter * bottleneck_width * num_group // 256
    c = sym.Convolution(data=data, num_filter=mid, kernel=(1, 1),
                        no_bias=True, name=name + "_conv1")
    c = _bn(c, name + "_bn1")
    c = sym.Activation(data=c, act_type="relu")
    c = sym.Convolution(data=c, num_filter=mid, kernel=(3, 3),
                        stride=stride, pad=(1, 1), num_group=num_group,
                        no_bias=True, name=name + "_conv2")
    c = _bn(c, name + "_bn2")
    c = sym.Activation(data=c, act_type="relu")
    c = sym.Convolution(data=c, num_filter=num_filter, kernel=(1, 1),
                        no_bias=True, name=name + "_conv3")
    body = _bn(c, name + "_bn3")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=data, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
        shortcut = _bn(shortcut, name + "_sc_bn")
    return sym.Activation(data=body + shortcut, act_type="relu")


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               bottleneck_width=4, **kwargs):
    if num_layers not in _UNITS:
        raise ValueError("resnext depth must be one of %s"
                         % sorted(_UNITS))
    units = _UNITS[num_layers]
    filters = [256, 512, 1024, 2048]

    data = sym.Variable("data")
    body = sym.Convolution(data=data, num_filter=64, kernel=(7, 7),
                           stride=(2, 2), pad=(3, 3), no_bias=True,
                           name="conv0")
    body = _bn(body, "bn0")
    body = sym.Activation(data=body, act_type="relu")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pad=(1, 1), pool_type="max")
    for i, (n_unit, n_filter) in enumerate(zip(units, filters)):
        stride = (1, 1) if i == 0 else (2, 2)
        body = resnext_unit(body, n_filter, stride, False,
                            "stage%d_unit1" % (i + 1), num_group,
                            bottleneck_width)
        for j in range(1, n_unit):
            body = resnext_unit(body, n_filter, (1, 1), True,
                                "stage%d_unit%d" % (i + 1, j + 1),
                                num_group, bottleneck_width)
    pool = sym.Pooling(data=body, global_pool=True, pool_type="avg",
                       kernel=(7, 7))
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
