"""The port's registry (``grbaz_tpu_torch/registry.py``) passes the JAX
package's ``tests/test_registry.py``, and is the JAX registry pointed
into the port: the same names, categories and reference analogs, each
entry resolving to an object of ``grbaz_tpu_torch``."""

import inspect

import pytest

from grbaz_tpu import registry as jregistry
from grbaz_tpu_torch import registry


# -- tests/test_registry.py on the port's copy ------------------------------

@pytest.mark.parametrize("name", sorted(registry.REGISTRY))
def test_entry_resolves(name):
    obj = registry.resolve(name)
    assert obj is not None


def test_taxonomy_helpers():
    cats = registry.categories()
    assert "Networking" in cats and "Applications/P25" in cats
    nets = registry.blocks_by_category("Networking")
    assert "udp_source" in nets
    assert registry.find("burst") == ["burst_buffer", "burst_tagger",
                                      "burster", "burster_config"]
    t = registry.tree()
    assert "[grbaz_tpu_torch]" in t and "fractional_resampler" in t


# -- against the JAX registry -----------------------------------------------

def test_same_names_categories_and_analogs():
    assert len(registry.REGISTRY) == len(jregistry.REGISTRY) == 97
    assert set(registry.REGISTRY) == set(jregistry.REGISTRY)
    for name, (cat, target, ref) in registry.REGISTRY.items():
        jcat, jtarget, jref = jregistry.REGISTRY[name]
        assert (cat, ref) == (jcat, jref), name
        assert target == jtarget.replace("grbaz_tpu.", "grbaz_tpu_torch.",
                                         1), name
    assert registry.categories() == jregistry.categories()
    for cat in registry.categories():
        assert registry.blocks_by_category(cat) == {
            n: (p.replace("grbaz_tpu.", "grbaz_tpu_torch.", 1), r)
            for n, (p, r) in jregistry.blocks_by_category(cat).items()}
    assert registry.tree().splitlines()[1:] == [
        line.replace("(grbaz_tpu.", "(grbaz_tpu_torch.")
        for line in jregistry.tree().splitlines()[1:]]


@pytest.mark.parametrize("name", sorted(registry.REGISTRY))
def test_entry_is_an_object_of_the_port(name):
    obj = registry.resolve(name)
    mod = inspect.getmodule(obj)
    assert mod is not None and mod.__name__.startswith("grbaz_tpu_torch."), \
        (name, mod)
    jobj = jregistry.resolve(name)
    assert obj.__name__ == jobj.__name__ and obj is not jobj
