"""The port's image-classification zoo against the JAX package's on the
CPU, second part: GoogLeNet, Inception-BN and Inception-v3, with the
checks and the tolerance of ``test_torch_zoo_convnets.py`` (names and
shapes at the published input; one forward and backward at batch 1 of
the smallest input each network takes, every gradient within 1e-5 of the
JAX executor's by relative norm)."""
import pytest

from test_torch_zoo_convnets import check_forward_backward, \
    check_names_and_shapes


@pytest.mark.parametrize("network,image", [
    ("googlenet", 224), ("inception-bn", 224), ("inception-v3", 299)])
def test_symbols_match_the_jax_zoo(network, image):
    check_names_and_shapes(network, {}, image)


@pytest.mark.parametrize("network,image", [
    ("googlenet", 32),            # five halvings to a global pool
    ("inception-bn", 32),
    ("inception-v3", 75),         # the smallest its stem and reductions take
])
def test_forward_backward_match_the_jax_executor(monkeypatch, network,
                                                 image):
    check_forward_backward(monkeypatch, network, {}, image)
