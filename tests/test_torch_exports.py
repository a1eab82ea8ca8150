"""The port's subpackages export the JAX package's names: ``models``, ``ops``,
``utils`` and ``parallel`` have the same ``__all__``, with ``from_torch`` in
place of ``from_flax``, and every listed name resolves."""

import importlib

import pytest

# JAX name -> the port's
RENAMED = {"from_flax": "from_torch"}


@pytest.mark.parametrize("sub", ["models", "ops", "utils", "parallel", "parallel.mesh"])
def test_subpackage_exports_match_jax(sub):
    jax_mod = importlib.import_module(f"continuousnormalizingflows_tpu.{sub}")
    port = importlib.import_module(f"continuousnormalizingflows_tpu_torch.{sub}")
    assert sorted(port.__all__) == sorted(RENAMED.get(n, n) for n in jax_mod.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
