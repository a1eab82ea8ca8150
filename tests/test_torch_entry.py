"""The port's entry points (``graft_entry``) and usage example against the
JAX package's ``__graft_entry__.py`` and ``examples/usage.py``.

``entry(device="cpu")``'s loss is held against ``__graft_entry__.entry()``'s
with JAX's params and points carried across and the draws (probe, end
time) injected into both, at rtol 2e-5 (one float32 rk4-32 solve, sums in
another order).  ``usage.py`` runs on the CPU at 2 epochs into a temporary
directory and must end with the served log-density matching ``log_prob``.
``dryrun_multichip``'s rank body runs in ``tests/test_torch_parallel.py``'s
4-rank spawn."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import continuousnormalizingflows_tpu.core as jcore
import continuousnormalizingflows_tpu_torch.core as tcore
from continuousnormalizingflows_tpu_torch import graft_entry, usage
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax


def test_entry_loss_matches_jax(monkeypatch):
    fn_j, (p_j, xs_j, key) = jentry.entry()
    fn_t, (p_t, xs_t, gen) = graft_entry.entry(device="cpu")
    assert xs_t.shape == xs_j.shape == (256, 2) and xs_t.device.type == "cpu"
    assert set(p_t) == set(params_from_jax(jax.device_get(p_j)))
    assert np.isfinite(float(fn_t(p_t, xs_t, gen)))
    rng = np.random.default_rng(0)
    eps = rng.standard_normal((1, 256, 5)).astype(np.float32)
    t1 = np.float32(1.04)
    monkeypatch.setattr(jcore, "sample_probe", lambda cfg, k, b: jnp.asarray(eps))
    monkeypatch.setattr(jcore, "steer_t1", lambda cfg, k: jnp.float32(t1))
    monkeypatch.setattr(tcore, "sample_probe", lambda cfg, g, b, d: torch.from_numpy(eps))
    monkeypatch.setattr(tcore, "steer_t1", lambda cfg, g, d: torch.tensor(t1))
    l_j = float(jax.jit(fn_j)(p_j, xs_j, key))
    l_t = float(fn_t(params_from_jax(jax.device_get(p_j)),
                     torch.from_numpy(np.array(xs_j)), gen))
    np.testing.assert_allclose(l_t, l_j, rtol=2e-5)


def test_entry_points_default_to_the_card():
    """Without CUDA, the hooks raise and name ``device="cpu"`` rather than
    run on the CPU unasked (the dryrun before it spawns a rank)."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graft_entry.dryrun_multichip(4)


def test_usage_example_on_the_cpu(tmp_path):
    """``python -m continuousnormalizingflows_tpu_torch.usage --device cpu
    --epochs 2``: fit, save and load, density, samples, trajectories, the
    logistic refit, and the served log-density matching ``log_prob``; every
    output under ``--out``."""
    out = tmp_path / "usage"
    assert usage.main(["--out", str(out), "--device", "cpu", "--epochs", "2"]) == 0
    res = json.loads((out / "usage.json").read_text())
    assert res["served_matches"] and res["served_max_abs_diff"] <= usage.SERVED_ATOL
    assert res["iterations"] == 2 and res["pairs"] == [8, 1]
    for k in ("final_loss", "logistic_final_loss", "mad", "sample_mean", "trace_free_mean"):
        assert np.isfinite(res[k]), k
    assert {"icnf-machine", "model.pt2", "usage.json"} <= set(os.listdir(out))
    assert set(os.listdir(tmp_path)) == {"usage"}
