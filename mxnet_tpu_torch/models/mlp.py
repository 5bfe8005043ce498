"""3-layer perceptron — the reference's smallest integration-test network
(``example/image-classification/symbols/mlp.py``, exercised by
``tests/python/train/test_mlp.py``)."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    net = sym.Flatten(data=data)
    net = sym.FullyConnected(data=net, num_hidden=128, name="fc1")
    net = sym.Activation(data=net, act_type="relu", name="relu1")
    net = sym.FullyConnected(data=net, num_hidden=64, name="fc2")
    net = sym.Activation(data=net, act_type="relu", name="relu2")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(data=net, name="softmax")
