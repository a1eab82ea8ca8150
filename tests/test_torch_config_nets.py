"""Port vs JAX: config validation and derived sizes, the MLP forward, the
parameter conversion and the Glorot init."""

import math

import jax
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu import config as jconfig
from continuousnormalizingflows_tpu_torch import config as tconfig
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax, params_to_jax


class _NoSampler:
    sample_fn = None
    logpdf_fn = None

    def __repr__(self) -> str:  # a stable test id: every worker collects the same tests
        return "_NoSampler()"


BAD_SOLVER = [
    dict(method="rk5"),
    dict(abm_order=0),
    dict(abm_order=13),
    dict(gradient="forward"),
    dict(dt0="fast"),
    dict(dt0=0.0),
    dict(method="dopri5", gradient="backprop"),
    dict(method="rk4", gradient="quadrature"),
]

BAD_ICNF = [
    dict(nvariables=0),
    dict(probe_dist=_NoSampler()),
    dict(probe_dist=3),
    dict(steer_dist=_NoSampler()),
    dict(base_dist=_NoSampler()),
    dict(layout="columns"),
    dict(exact_chunk=-1),
]


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kwargs", BAD_SOLVER, ids=str)
def test_solver_validation_matches_jax(kwargs):
    assert _message(lambda: tconfig.SolverConfig(**kwargs)) == _message(
        lambda: jconfig.SolverConfig(**kwargs)
    )


@pytest.mark.parametrize("kwargs", BAD_ICNF, ids=str)
def test_icnf_validation_matches_jax(kwargs):
    assert _message(lambda: tconfig.ICNFConfig(**kwargs)) == _message(
        lambda: jconfig.ICNFConfig(**kwargs)
    )


@pytest.mark.parametrize(
    "kwargs",
    [dict(layout="feature_first"), dict(probe_axis="model"), dict(sweep_axis="model")],
    ids=str,
)
def test_unported_options_raise(kwargs):
    """The options that once raised: ``feature_first`` and the mesh axes are
    accepted (the axes unvalidated as in JAX), with JAX's derived sizes."""
    t, j = tconfig.ICNFConfig(**kwargs), jconfig.ICNFConfig(**kwargs)
    for k, v in kwargs.items():
        assert getattr(t, k) == getattr(j, k) == v
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name


DERIVED = ["augmented", "conditioned", "steered", "nz", "n_aug_input", "state_dim", "n_in",
           "n_out", "norm_z", "norm_j", "norm_z_aug"]


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(nvariables=2),
        dict(nvariables=43, naugments=0, lambda_3=0.0),
        dict(nvariables=3, nconditions=2, autonomous=True, steer_rate=0.0),
        dict(nvariables=1, naugments=4, lambda_1=0.0, lambda_2=0.0),
    ],
    ids=str,
)
def test_derived_sizes_match_jax(kwargs):
    t, j = tconfig.ICNFConfig(**kwargs), jconfig.ICNFConfig(**kwargs)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name
    for mode in tconfig.Mode:
        assert t.trace_for(mode).value == j.trace_for(jconfig.Mode(mode.value)).value
    assert t.tspan == j.tspan and t.naugments == j.naugments


def test_create_defaults_match_jax():
    t = tcnf.ICNF.create(nvariables=2)
    j = jcnf.ICNF.create(nvariables=2)
    assert t.net.widths == j.net.widths == (6, 24, 24, 5)
    for f in ("lambda_1", "lambda_2", "lambda_3", "steer_rate", "nprobes", "fused"):
        assert getattr(t.config, f) == getattr(j.config, f), f
    assert t.config.solver.method == j.config.solver.method


@pytest.mark.parametrize("widths", [(6, 24, 24, 5), (3, 12, 3), (44, 176, 176, 43)], ids=str)
def test_mlp_forward_matches_jax(widths):
    jnet = jcnf.MLP(widths)
    jparams = jnet.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((32, widths[0])).astype(np.float32)
    y_j = np.asarray(jnet.apply(jparams, x))
    tnet = tcnf.MLP(widths)
    y_t = tnet.apply(params_from_jax(jax.device_get(jparams)), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)


def test_params_round_trip():
    jparams = jax.device_get(jcnf.MLP((6, 24, 24, 5)).init(jax.random.PRNGKey(3)))
    back = params_to_jax(params_from_jax(jparams))
    for a, b in zip(jparams, back):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])
        np.testing.assert_array_equal(np.asarray(a["b"]), b["b"])
    tparams = tcnf.MLP((6, 24, 24, 5)).init(torch.Generator().manual_seed(0), device="cpu")
    again = params_from_jax(params_to_jax(tparams))
    for k in tparams:
        torch.testing.assert_close(again[k], tparams[k], rtol=0, atol=0)


def test_glorot_init_shapes_and_bounds():
    widths = (6, 24, 24, 5)
    tparams = tcnf.MLP(widths).init(torch.Generator().manual_seed(0), device="cpu")
    jparams = jcnf.MLP(widths).init(jax.random.PRNGKey(0))
    for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
        w = tparams[f"layers.{i}.weight"]
        assert tuple(w.shape) == (w_out, w_in) == tuple(jparams[i]["w"].T.shape)
        limit = math.sqrt(6.0 / (w_in + w_out))
        assert float(w.abs().max()) <= limit
        assert float(w.std()) > 0.4 * limit  # uniform(-l, l) has std l/sqrt(3)
        assert torch.all(tparams[f"layers.{i}.bias"] == 0)
    # one seed, one draw
    again = tcnf.MLP(widths).init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(again[k], tparams[k]) for k in tparams)


def test_icnf_rejects_mismatched_net():
    cfg = tconfig.ICNFConfig(nvariables=2)
    with pytest.raises(ValueError, match="do not match"):
        tcnf.ICNF(config=cfg, net=tcnf.MLP((5, 8, 5)))
