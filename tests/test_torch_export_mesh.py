"""``export_logpdf(mesh=)`` of the port against its unsharded export and the
JAX package's (``tests/test_export.py``'s SPMD cases): on 2 gloo ranks (a
2 x 1 mesh) and on 4 (2 x 2), each rank started by
``tests/_torch_parallel_ranks.py``, exports its program, serves its data
shard of 32 points, and saves and reloads it with the mesh.

Tolerances: every rank's solve takes the unsharded export's steps (NFE,
accepted and rejected equal); the shards' log-densities against the
unsharded export at rtol 1e-6 (the error norm's sum of squares is summed
per rank, then over the ranks, in float64), against JAX's export at rtol
1e-5 (fp32 solves, sums in another order); a data shard's model ranks give
the same bits, as does the reloaded program."""

import os

import jax
import numpy as np
import pytest
import torch

import continuousnormalizingflows_tpu as jcnf
import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu.config import SolverConfig as JSolver
from continuousnormalizingflows_tpu.utils import export as jex
from continuousnormalizingflows_tpu_torch.config import SolverConfig
from continuousnormalizingflows_tpu_torch.utils import export as ex
from continuousnormalizingflows_tpu_torch.utils.convert import params_from_jax

import _torch_parallel_ranks as ranks

JOIN_S = 120
SOLVERS = {"abm": dict(method="abm", rtol=1e-4, atol=1e-4, gradient="quadrature"),
           "dopri5": dict(method="dopri5", rtol=1e-4, atol=1e-4)}
# (world, case): abm on the 2 x 1 mesh, dopri5 on the 2 x 2 one
RUNS = [(2, "abm"), (4, "dopri5")]


def _inputs():
    """The global batch and the model, JAX's init with its weights doubled
    (a field on which both solvers reject a step)."""
    x = (0.4 * np.random.default_rng(0).standard_normal((32, 2))).astype(np.float32)
    jicnf = jcnf.ICNF.create(nvariables=2)
    layers = jax.tree_util.tree_map(lambda v: 2.0 * np.asarray(v, np.float32),
                                    jax.device_get(jicnf.init(jax.random.PRNGKey(0))))
    out = {"exp.x": x}
    out.update({f"exp.p.{i}.{k}": v for i, layer in enumerate(layers) for k, v in layer.items()})
    return out, layers


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs, layers = _inputs()
    got = {}
    for world, case in RUNS:
        work = str(tmp_path_factory.mktemp(f"export{world}"))
        np.savez(os.path.join(work, "inputs.npz"), **inputs)
        got[case] = ranks.spawn(world, [f"export_{case}"], work, JOIN_S)[f"export_{case}"]
    return inputs, layers, got


def _unsharded(case, layers, x):
    icnf = tcnf.ICNF.create(nvariables=2, solver=SolverConfig(**SOLVERS[case]))
    lp, nfe, nacc, nrej = ex._export_logpdf(icnf, params_from_jax(layers),
                                            device="cpu").call(torch.from_numpy(x))
    return lp.numpy(), [int(nfe), int(nacc), int(nrej)]


def _shards(per_rank):
    """The log-densities of the data shards in order (model rank 0's)."""
    return np.concatenate([r["lp"] for r in sorted(per_rank, key=lambda r: tuple(r["coord"]))
                           if r["coord"][1] == 0])


@pytest.mark.parametrize("world,case", RUNS)
def test_every_rank_takes_the_unsharded_exports_steps(run, world, case):
    inputs, layers, got = run
    _lp, stats = _unsharded(case, layers, inputs["exp.x"])
    assert stats[2] > 0  # the field rejects a step: the controller is exercised
    for r in got[case]:
        assert list(r["stats"]) == stats
        assert tuple(r["mesh"]) == (2, world // 2)


@pytest.mark.parametrize("world,case", RUNS)
def test_shards_match_the_unsharded_export_and_jax(run, world, case):
    inputs, layers, got = run
    x = inputs["exp.x"]
    lp, _stats = _unsharded(case, layers, x)
    np.testing.assert_allclose(_shards(got[case]), lp, rtol=1e-6, atol=1e-7)
    jicnf = jcnf.ICNF.create(nvariables=2, solver=JSolver(**SOLVERS[case]))
    want = jex.export_logpdf(jicnf, layers).call(x)
    np.testing.assert_allclose(_shards(got[case]), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world,case", RUNS)
def test_model_ranks_replicate_and_the_reload_is_checked(run, world, case):
    """A data shard's model ranks serve it alike; the saved program reloads
    with the mesh to the same bits, and without it is refused."""
    _inputs_, _layers, got = run
    by_coord = {tuple(r["coord"]): r for r in got[case]}
    for (d, m), r in by_coord.items():
        np.testing.assert_array_equal(r["lp"], by_coord[(d, 0)]["lp"])
        assert bool(r["reloaded_same"][0]) and not bool(r["loads_without_mesh"][0])
