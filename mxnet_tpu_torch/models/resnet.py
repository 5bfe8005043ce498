"""ResNet v1 (He et al. 2015) and v2 pre-activation (He et al. 2016):
``mxnet_tpu/models/resnet.py`` with the same graph and the same argument
and aux-state names and shapes, so a checkpoint of either package loads
in the other.

Capability parity with the reference's
``example/image-classification/symbols/resnet.py`` (which implements the
pre-activation variant): depths 18/34/50/101/152/200 for ImageNet-shaped
inputs, plus the CIFAR 6n+2 form when ``image_shape`` is small.
"""
from .. import symbol as sym

class _Layout:
    """Graph-construction layout: NCHW (reference default) or NHWC, the
    channels-last form (cuDNN's NHWC on the card).  Threaded explicitly
    through the builders so concurrent get_symbol calls cannot
    interfere."""

    def __init__(self, layout=None):
        self.channels_last = (layout is not None and
                              layout.upper() == "NHWC")
        self.layout = "NHWC" if self.channels_last else None
        self.bn_axis = 3 if self.channels_last else 1

    def conv(self, **kw):
        if self.layout:
            kw.setdefault("layout", self.layout)
        return sym.Convolution(**kw)

    def pool(self, **kw):
        if self.layout:
            kw.setdefault("layout", self.layout)
        return sym.Pooling(**kw)

    def bn(self, net, name):
        return sym.BatchNorm(data=net, fix_gamma=False, eps=2e-5,
                             momentum=0.9, axis=self.bn_axis, name=name)

_NCHW = _Layout()


_IMAGENET_UNITS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
    200: ([3, 24, 36, 3], True),
}




def residual_unit(data, num_filter, stride, dim_match, name,
                  bottleneck=True, version=2, L=_NCHW):
    """One residual unit.  v2 = BN-relu-conv preact; v1 = conv-BN-relu.
    ``L`` is the :class:`_Layout` threading conv/pool/BN layout."""
    if version == 2:
        bn1 = L.bn(data, name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu")
        if bottleneck:
            c1 = L.conv(data=act1, num_filter=num_filter // 4,
                                 kernel=(1, 1), no_bias=True,
                                 name=name + "_conv1")
            bn2 = L.bn(c1, name + "_bn2")
            act2 = sym.Activation(data=bn2, act_type="relu")
            c2 = L.conv(data=act2, num_filter=num_filter // 4,
                                 kernel=(3, 3), stride=stride, pad=(1, 1),
                                 no_bias=True, name=name + "_conv2")
            bn3 = L.bn(c2, name + "_bn3")
            act3 = sym.Activation(data=bn3, act_type="relu")
            body = L.conv(data=act3, num_filter=num_filter,
                                   kernel=(1, 1), no_bias=True,
                                   name=name + "_conv3")
        else:
            c1 = L.conv(data=act1, num_filter=num_filter,
                                 kernel=(3, 3), stride=stride, pad=(1, 1),
                                 no_bias=True, name=name + "_conv1")
            bn2 = L.bn(c1, name + "_bn2")
            act2 = sym.Activation(data=bn2, act_type="relu")
            body = L.conv(data=act2, num_filter=num_filter,
                                   kernel=(3, 3), pad=(1, 1), no_bias=True,
                                   name=name + "_conv2")
        if dim_match:
            shortcut = data
        else:
            shortcut = L.conv(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return body + shortcut
    # v1
    if bottleneck:
        c1 = L.conv(data=data, num_filter=num_filter // 4,
                             kernel=(1, 1), no_bias=True,
                             name=name + "_conv1")
        b1 = L.bn(c1, name + "_bn1")
        a1 = sym.Activation(data=b1, act_type="relu")
        c2 = L.conv(data=a1, num_filter=num_filter // 4,
                             kernel=(3, 3), stride=stride, pad=(1, 1),
                             no_bias=True, name=name + "_conv2")
        b2 = L.bn(c2, name + "_bn2")
        a2 = sym.Activation(data=b2, act_type="relu")
        c3 = L.conv(data=a2, num_filter=num_filter, kernel=(1, 1),
                             no_bias=True, name=name + "_conv3")
        body = L.bn(c3, name + "_bn3")
    else:
        c1 = L.conv(data=data, num_filter=num_filter, kernel=(3, 3),
                             stride=stride, pad=(1, 1), no_bias=True,
                             name=name + "_conv1")
        b1 = L.bn(c1, name + "_bn1")
        a1 = sym.Activation(data=b1, act_type="relu")
        c2 = L.conv(data=a1, num_filter=num_filter, kernel=(3, 3),
                             pad=(1, 1), no_bias=True, name=name + "_conv2")
        body = L.bn(c2, name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        sc = L.conv(data=data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True, name=name + "_sc")
        shortcut = L.bn(sc, name + "_sc_bn")
    return sym.Activation(data=body + shortcut, act_type="relu")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               version=2, layout=None, conv0_space_to_depth=False, **kwargs):
    """``layout="NHWC"`` builds the channels-last network (feed data as
    (N, H, W, C)); default NCHW matches the reference.

    ``conv0_space_to_depth`` (NHWC only) rearranges the input to
    (N, H/2, W/2, 12) in-graph and replaces the 7x7/s2 stem with a
    3x3/s1 conv over the depth-stacked pixels: 4x the stem's input
    channels at 1/4 the spatial traffic (the MLPerf ResNet stem
    trick).  An architecture variant: the stem's receptive field is
    6x6 and its weights are not checkpoint-compatible with the 7x7
    stem."""
    L = _Layout(layout)
    if L.channels_last and image_shape[0] <= 4 < image_shape[-1]:
        # accept the reference's (C, H, W) spelling under NHWC too
        image_shape = tuple(image_shape[1:]) + (image_shape[0],)
    small_image = (image_shape[1] if L.channels_last
                   else image_shape[-1]) <= 64
    data = sym.Variable("data")
    if small_image:
        # CIFAR form: 6n+2 layers, 3 stages of n non-bottleneck units
        if (num_layers - 2) % 6 != 0:
            raise ValueError("cifar resnet depth must be 6n+2")
        n = (num_layers - 2) // 6
        units, bottleneck = [n, n, n], False
        filters = [16, 32, 64]
        body = L.conv(data=data, num_filter=16, kernel=(3, 3),
                      pad=(1, 1), no_bias=True, name="conv0")
    else:
        if num_layers not in _IMAGENET_UNITS:
            raise ValueError("resnet depth must be one of %s"
                             % sorted(_IMAGENET_UNITS))
        units, bottleneck = _IMAGENET_UNITS[num_layers]
        filters = ([256, 512, 1024, 2048] if bottleneck
                   else [64, 128, 256, 512])
        if conv0_space_to_depth:
            if not L.channels_last:
                raise ValueError("conv0_space_to_depth requires "
                                 "layout='NHWC'")
            h, w = image_shape[0], image_shape[1]
            # (N,H,W,3) -> (N,H/2,2,W/2,2,3) -> (N,H/2,W/2,12)
            body = sym.Reshape(data=data,
                               shape=(0, h // 2, 2, w // 2, 2, 3))
            body = sym.transpose(body, axes=(0, 1, 3, 2, 4, 5))
            body = sym.Reshape(data=body, shape=(0, h // 2, w // 2, 12))
            body = L.conv(data=body, num_filter=64, kernel=(3, 3),
                          stride=(1, 1), pad=(1, 1), no_bias=True,
                          name="conv0")
        else:
            body = L.conv(data=data, num_filter=64, kernel=(7, 7),
                          stride=(2, 2), pad=(3, 3), no_bias=True,
                          name="conv0")
        body = L.bn(body, "bn0")
        body = sym.Activation(data=body, act_type="relu")
        body = L.pool(data=body, kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), pool_type="max")
    for i, (nu, nf) in enumerate(zip(units, filters)):
        first_stride = (1, 1) if i == 0 and not small_image else \
            ((1, 1) if i == 0 else (2, 2))
        body = residual_unit(body, nf, first_stride, False,
                             "stage%d_unit1" % (i + 1), bottleneck, version,
                             L=L)
        for j in range(1, nu):
            body = residual_unit(body, nf, (1, 1), True,
                                 "stage%d_unit%d" % (i + 1, j + 1),
                                 bottleneck, version, L=L)
    if version == 2:
        body = L.bn(body, "bn_final")
        body = sym.Activation(data=body, act_type="relu")
    pool = L.pool(data=body, global_pool=True, pool_type="avg",
                  kernel=(7, 7), name="pool_final")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
