"""The weight carrier on every entrypoint: each of the 297 names of the JAX
registry built on the meta device, its state dict through the JAX
package's converter and back through ``variables_to_state_dict`` with the
model's names. Every model here is built on
``torch.device("meta")`` and never run."""

import numpy as np
import pytest
import torch

from scouter_tpu.models.convert import torch_state_dict_to_variables
from scouter_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from scouter_tpu_torch.models import convert, variables_to_state_dict
from test_torch_zoo_registry import meta_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_names_round_trip_through_the_jax_converter(name, monkeypatch):
    """Each entrypoint's state dict, shapes only, through the JAX package's
    ``torch_state_dict_to_variables`` and back through
    ``variables_to_state_dict`` with the model's names: every key and shape
    comes back (DPN's ``conv2_1``, Inception's ``branch3x3dbl_1``, NASNet's
    ``cell_0`` and Inception-ResNet's ``repeat_1.0`` included)."""
    sd = meta_model(name).state_dict()
    tree = torch_state_dict_to_variables(
        {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in sd.items()})
    # shapes only: the leaves stay unallocated
    monkeypatch.setattr(convert, "_tensor",
                        lambda arr: torch.empty(np.shape(arr), device="meta"))
    back = variables_to_state_dict(tree, sd.keys())
    assert {k: tuple(v.shape) for k, v in back.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_an_ambiguous_name_resolves_by_the_model():
    """The flax name ``conv2_1`` is DPN's attribute there and a container
    index elsewhere; the carrier gives each model its own."""
    tree = {"params": {"features": {"conv2_1": {"c1x1_a": {"conv": {
        "kernel": np.zeros((1, 1, 10, 128), np.float32)}}}}}}
    assert list(variables_to_state_dict(tree, [])) == ["features.conv2.1.c1x1_a.conv.weight"]
    got = variables_to_state_dict(tree, meta_model("dpn68").state_dict().keys())
    assert list(got) == ["features.conv2_1.c1x1_a.conv.weight"]
    with pytest.raises(ValueError, match="share the flax name"):
        variables_to_state_dict(tree, ["a.conv2_1.w", "a.conv2.1.w"])
