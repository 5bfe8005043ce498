"""LeNet-5 style convnet (reference
``example/image-classification/symbols/lenet.py``)."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20, name="conv1")
    a1 = sym.Activation(data=c1, act_type="tanh")
    p1 = sym.Pooling(data=a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(data=p1, kernel=(5, 5), num_filter=50, name="conv2")
    a2 = sym.Activation(data=c2, act_type="tanh")
    p2 = sym.Pooling(data=a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fl = sym.Flatten(data=p2)
    f1 = sym.FullyConnected(data=fl, num_hidden=500, name="fc1")
    a3 = sym.Activation(data=f1, act_type="tanh")
    f2 = sym.FullyConnected(data=a3, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(data=f2, name="softmax")
