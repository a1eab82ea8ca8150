"""FFJORD's multiscale flow in the port (``MultiscaleICNF``, ``ConcatConvNet``)
against the benchmark's plain reference (``port_bench/reference/multiscale.py``)
on the CPU, at (3, 8, 8) with hidden widths (8, 8, 8): 2 scales, 6 blocks, a
batch of 4, rk4 in 2 steps, on seeded weights and draws.

Tolerances, and why: the port and the reference run the same convolutions
on the same operands (equal to float32 rounding, ~1e-7 of a value); the two
adjoints sum their rk4 stages and the chain's terms in other orders, so the
gradients agree to ~1e-6 of their norm (the float64 run agrees to 1e-12);
after an Adam step a leaf whose gradient is nought to rounding moves by
the sign of its rounding, so the fit comparison holds the parameters to
1e-5 of a step's size (``lr``)."""

import ast
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import continuousnormalizingflows_tpu_torch as cnf
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.models import multiscale
from continuousnormalizingflows_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench.reference import cnf as ref_cnf  # noqa: E402
from port_bench.reference import multiscale as ref  # noqa: E402

SHAPE = (3, 8, 8)
HIDDEN = (8, 8, 8)
B = 4
SOLVER = SolverConfig(method="rk4", fixed_steps=2, gradient="adjoint")
LAMBDAS = (0.01, 0.01)
ALPHA = 1e-6


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset_counters()
    profiling.records(clear=True)
    yield
    profiling.records(clear=True)


def _chain(dtype=torch.float32, **kw):
    return cnf.MultiscaleICNF.create(shape=SHAPE, hidden=HIDDEN, solver=SOLVER, alpha=ALPHA,
                                     lambda_1=LAMBDAS[0], lambda_2=LAMBDAS[1], dtype=dtype, **kw)


def _params(chain, seed=3):
    return chain.init(torch.Generator().manual_seed(seed), device="cpu")


def _pixels(n, seed=5, dtype=torch.float32):
    """Dequantised rows in [0, 1]: 8-bit values and the noise."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (n, 192), generator=g).to(dtype)
    return (x + torch.rand((n, 192), generator=g, dtype=dtype)) / 256.0


def _probes(state, dims, n, dtype=torch.float32):
    """The blocks' Rademacher probes as the port draws them, in block order."""
    g = torch.Generator()
    g.set_state(state)
    return [2.0 * torch.randint(0, 2, (1, n, d), generator=g)[0].to(dtype) - 1.0 for d in dims]


def _dims(chain):
    return [b.config.nz for b in chain.blocks]


def test_the_layout_is_ffjords():
    chain = cnf.MultiscaleICNF.create()
    shapes = [b.net.shape for b in chain.blocks]
    assert shapes == ref.block_shapes((3, 32, 32)) == [
        (3, 32, 32)] * 2 + [(12, 16, 16)] * 2 + [(6, 16, 16)] * 2 + [(24, 8, 8)] * 2 + [
        (12, 8, 8)] * 2 + [(48, 4, 4)] * 2 + [(24, 4, 4)] * 2
    assert sum(p.numel() for b in chain.blocks for p in b.net.parameters()) == 1_358_868
    kinds = [s.kind for s in chain.steps]
    assert kinds.count("squeeze") == kinds.count("factor") == 3
    assert [s.kind for s in _chain().steps] == [
        "block", "block", "squeeze", "block", "block", "factor", "block", "block"]
    cfg = chain.blocks[0].config
    assert (cfg.naugments, cfg.autonomous, cfg.steer_rate, cfg.lambda_3) == (0, False, 0.0, 0.0)
    assert cfg.probe_dist is cnf.ProbeDist.RADEMACHER and chain.config.nvariables == 3072


def test_the_field_matches_the_reference():
    net = cnf.ConcatConvNet(SHAPE, HIDDEN)
    params = net.init(torch.Generator().manual_seed(1), device="cpu")
    z = torch.randn((B, 192), generator=torch.Generator().manual_seed(2))
    t = torch.tensor(0.375)
    got = net.apply(params, torch.cat([z, t.expand(B, 1)], dim=1))
    want = ref.field(list(params.values()), z, t, SHAPE, "fp32")
    # the same convolutions on the same operands
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert net.n_in == 193 and net.n_out == 192


def test_the_written_probe_vjp_is_autograds():
    from continuousnormalizingflows_tpu_torch.ops import dynamics

    net = cnf.ConcatConvNet(SHAPE, HIDDEN, dtype=torch.float64)
    params = net.init(torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.cat([torch.randn((B, 192), generator=g, dtype=torch.float64),
                   torch.full((B, 1), 0.25, dtype=torch.float64)], dim=1)
    eps = 2.0 * torch.randint(0, 2, (2, B, 192), generator=g).double() - 1.0
    f, ej = dynamics._conv_probe_vjps(net, params, x, eps)
    f2, ej2 = dynamics._probe_vjps(
        lambda z: net.apply(params, torch.cat([z, x[:, -1:]], dim=1)), x[:, :-1], eps, ())
    # float64: the same products in another order
    torch.testing.assert_close(f, f2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ej, ej2, rtol=1e-12, atol=1e-12)
    with torch.no_grad():  # the adjoint's forward solve: no graph
        assert dynamics._conv_probe_vjps(net, params, x, eps)[1].grad_fn is None


def test_init_follows_conv2ds_default_and_the_generator():
    net = cnf.ConcatConvNet(SHAPE, HIDDEN)
    a = net.init(torch.Generator().manual_seed(7), device="cpu")
    b = net.init(torch.Generator().manual_seed(7), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert list(a) == [f"layers.{i}.{n}" for i in range(4) for n in ("weight", "bias")]
    for i, cin in enumerate((3, 8, 8, 8)):
        bound = (9 * (cin + 1)) ** -0.5
        w, bias = a[f"layers.{i}.weight"], a[f"layers.{i}.bias"]
        assert w.shape[1:] == (cin + 1, 3, 3)
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.8 * bound
        assert float(bias.abs().max()) <= bound


def test_squeeze_and_its_inverse():
    x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(0))
    s = multiscale.squeeze(x)
    assert s.shape == (2, 12, 4, 4) and torch.equal(s, ref.squeeze(x))
    assert torch.equal(multiscale.unsqueeze(s), x) and torch.equal(ref.unsqueeze(s), x)
    # channel 4c + 2p + q holds pixel (2i + p, 2j + q) of channel c
    assert s[1, 4 * 2 + 2 * 1 + 0, 3, 1] == x[1, 2, 7, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_loss_and_adjoint_gradients_match_the_reference(dtype):
    chain = _chain(dtype)
    params = {k: v.requires_grad_() for k, v in _params(chain).items()}
    x = _pixels(B, dtype=dtype)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    loss, stats = chain.loss_with_stats(Mode.TRAIN, x, params, g)
    grads = torch.autograd.grad(loss, list(params.values()))
    ws = [v.detach().clone().requires_grad_() for v in params.values()]
    want = ref.train_terms(ws, x, _probes(state, _dims(chain), B, dtype), SHAPE, 2, ALPHA,
                           LAMBDAS, 2).mean()
    want_g = torch.autograd.grad(want, ws)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    assert float(abs(loss - want).detach()) <= tol * float(abs(want).detach())
    for a, b in zip(grads, want_g):
        norm = float(torch.linalg.vector_norm(b))
        assert float(torch.linalg.vector_norm(a - b)) <= 2 * tol * norm
    assert (stats.nfe, stats.naccept) == (6 * 8, 6 * 2)  # 6 blocks of 2 rk4 steps


def test_log_prob_matches_the_reference_and_scores():
    chain = _chain()
    params = _params(chain)
    x = _pixels(B)
    g = torch.Generator().manual_seed(12)
    state = g.get_state()
    got = chain.log_prob(Mode.TRAIN_NOREG, x, params, g)
    logp, e, n, z = ref.chain(list(params.values()), x, _probes(state, _dims(chain), B), SHAPE,
                              2, ALPHA, False, 2)
    torch.testing.assert_close(got, logp, rtol=1e-6, atol=1e-4)
    assert float(e.abs().max()) == float(n.abs().max()) == 0.0
    g.set_state(state)
    dist = cnf.ICNFDist(chain, params, mode=Mode.TRAIN_NOREG)
    torch.testing.assert_close(dist.logpdf(x, g), got)
    torch.testing.assert_close(chain.latents(x, params), z, rtol=1e-6, atol=1e-6)
    model = cnf.ICNFModel(chain, device="cpu")
    assert model.transform(x, params).shape == (B, 192)
    assert model.score(x, params) == pytest.approx(
        -float(chain.log_prob(Mode.TRAIN_NOREG, x, params,
                              torch.Generator().manual_seed(0)).mean()))


def test_two_fit_steps_match_the_reference_adam():
    chain = _chain()
    p0 = _params(chain)
    x8 = torch.randint(0, 256, (2 * B, 192), generator=torch.Generator().manual_seed(9))
    x8 = x8.to(torch.float32)
    g = torch.Generator().manual_seed(21)
    state = g.get_state()
    model = cnf.ICNFModel(chain, optimizer=cnf.default_optimizer(1e-3, 0.0), batchsize=B,
                          epochs=1, log_every=1, batch_transform=cnf.dequantize, device="cpu")
    res = model.fit(x8, params=p0, generator=g)
    idx, draws, _ = ref.fit_call_draws(state, "cpu", 2 * B, B, 2, _dims(chain))
    w = [v.clone() for v in p0.values()]
    adam, losses = None, []
    for k in range(2):
        u, eps = draws[k]
        wg = [t.requires_grad_() for t in w]
        loss = ref.train_terms(wg, (x8[idx[k]] + u) / 256.0, eps, SHAPE, 2, ALPHA, LAMBDAS,
                               2).mean()
        losses.append(float(loss))
        w, adam = ref_cnf.adam_step([t.detach() for t in wg], list(torch.autograd.grad(loss, wg)),
                                    adam, 1e-3, 0.0)
    assert res.history == pytest.approx(losses, rel=1e-6)
    for got, want in zip(res.params.values(), w):
        assert float((got - want).abs().max()) <= 1e-5 * 1e-3 * 2


def test_a_one_block_chain_is_the_plain_icnf_through_core():
    chain = _chain(nblocks=1, n_scale=1)
    assert [s.kind for s in chain.steps] == ["block"]
    icnf = cnf.ICNF.create(nvariables=192, naugments=0, probe_dist=cnf.ProbeDist.RADEMACHER,
                           steer_rate=0.0, lambda_1=LAMBDAS[0], lambda_2=LAMBDAS[1],
                           lambda_3=0.0, solver=SOLVER, net=cnf.ConcatConvNet(SHAPE, HIDDEN))
    params = _params(chain)
    x = _pixels(B)
    got = chain.loss_with_stats(Mode.TRAIN, x, params, torch.Generator().manual_seed(4))[0]
    y, logdet = multiscale._logit(x, ALPHA)
    plain = cnf.loss(icnf, Mode.TRAIN, y, chain.block_params(params, 0),
                     torch.Generator().manual_seed(4))
    torch.testing.assert_close(got, plain - logdet.mean())


@pytest.mark.parametrize("solver", [
    SolverConfig(method="rk4", fixed_steps=2, gradient="backprop"),
    SolverConfig(method="dopri5", rtol=1e-3, atol=1e-3),
])
def test_fused_true_falls_through_to_the_unfused_route(solver):
    def loss(fused):
        icnf = cnf.ICNF.create(nvariables=192, naugments=0, fused=fused, fused_adaptive=fused,
                               solver=solver, net=cnf.ConcatConvNet(SHAPE, HIDDEN))
        params = icnf.init(torch.Generator().manual_seed(2), device="cpu")
        return cnf.loss(icnf, Mode.TRAIN, _pixels(B), params, torch.Generator().manual_seed(3))
    torch.testing.assert_close(loss(True), loss(False), rtol=0, atol=0)
    routes = {k: v for k, v in profiling.counters().items() if k.startswith("solve.")}
    assert routes == {"solve.unfused": 2}


def test_one_fit_step_counts_and_spans_its_blocks():
    chain = _chain()
    model = cnf.ICNFModel(chain, batchsize=B, epochs=1, log_every=1,
                          batch_transform=cnf.dequantize, device="cpu")
    x = torch.randint(0, 256, (B, 192), generator=torch.Generator().manual_seed(1)).float()
    with profile(activities=[ProfilerActivity.CPU]):
        model.fit(x)
    recs = profiling.records()
    names = [r.name for r in recs]
    assert names.count("multiscale.block") == 6 and names.count("adjoint.backward") == 6
    assert names.count("multiscale.chain") == 1
    (chain_span,) = [r for r in recs if r.name == "multiscale.chain"]
    blocks = [r for r in recs if r.name == "multiscale.block"]
    assert all(r.parent == chain_span.id for r in blocks)
    assert [r.route for r in blocks] == ["0.0", "0.1", "0.2", "0.3", "1.4", "1.5"]
    c = profiling.counters()
    assert (c["multiscale.blocks"], c["multiscale.squeezes"], c["multiscale.factor_outs"]) == (
        6, 1, 1)
    assert c["solve.unfused"] == 6
    # the chain's span ends are made on the device: no block waits for the stream
    assert "host_reads.adjoint.times" not in c


def test_what_a_chain_refuses():
    chain = _chain()
    params = _params(chain)
    with pytest.raises(ValueError, match="no exact trace"):
        chain.log_prob(Mode.TEST, _pixels(B), params)
    with pytest.raises(ValueError, match="no exact trace"):
        cnf.ICNFDist(chain, params).logpdf(_pixels(B))
    with pytest.raises(ValueError, match="rows must be"):
        chain.log_prob(Mode.TRAIN_NOREG, torch.zeros((B, 10)), params,
                       torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="carry"):
        cnf.MultiscaleICNF.create(shape=SHAPE, solver=SolverConfig(dt0="carry"))


def test_mesh_with_a_chain_raises():
    from continuousnormalizingflows_tpu_torch import parallel

    mesh = parallel.make_mesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="mesh="):
            cnf.ICNFModel(_chain(), mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()


def test_the_conv_net_refuses_feature_first():
    icnf = cnf.ICNF.create(nvariables=192, naugments=0, layout="feature_first",
                           net=cnf.ConcatConvNet(SHAPE, HIDDEN),
                           solver=SolverConfig(method="rk4", fixed_steps=2, gradient="backprop"))
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="batch-first"):
        cnf.loss(icnf, Mode.TRAIN, _pixels(B), params, torch.Generator().manual_seed(0))


def test_the_reference_imports_only_torch():
    tree = ast.parse((ROOT / "port_bench/reference/multiscale.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "torch"}, names


class _Replay:
    """A CPU stand-in for ``ops.adjoint._Captured``: at capture, copies of
    the inputs; at each call the inputs copied in and ``fn`` run on those
    copies, as a graph replays its kernels on its static buffers."""

    made = 0

    def __init__(self, fn, inputs):
        type(self).made += 1
        self.fn, self.inputs = fn, [x.detach().clone() for x in inputs]

    def __call__(self, inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        outs, static = self.fn(*self.inputs)
        return [o.clone() for o in outs], static


def test_replayed_solves_read_only_their_inputs(monkeypatch):
    """Two fit steps with every block's solves captured and replayed (on the
    CPU by :class:`_Replay`) give the eager steps' parameters: the captured
    solves read the weights, state, cotangents and probes of each call."""
    from continuousnormalizingflows_tpu_torch.ops import adjoint

    x8 = torch.randint(0, 256, (2 * B, 192), generator=torch.Generator().manual_seed(9)).float()

    def fit(chain):
        model = cnf.ICNFModel(chain, batchsize=B, epochs=1, log_every=1,
                              batch_transform=cnf.dequantize, device="cpu")
        return model.fit(x8, params=_params(chain), generator=torch.Generator().manual_seed(5))

    eager = fit(_chain())
    monkeypatch.setattr(adjoint, "_capturable", lambda cfg, x: cfg.method in ("rk4", "euler"))
    monkeypatch.setattr(adjoint, "_Captured", _Replay)
    chain = _chain()
    replayed = fit(chain)
    assert _Replay.made == 2 * 6  # a forward and a backward solve a block, captured once
    assert sum(len(b.graphs[Mode.TRAIN]) for b in chain.blocks) == 12
    assert replayed.history == eager.history
    for k, v in eager.params.items():
        assert torch.equal(replayed.params[k], v), k
