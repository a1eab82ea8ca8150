"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  The machine with the
card has no JAX, so run this file there without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: one fp32 stage rtol 1e-4 / atol 1e-5 (same products, another
summation order); a 32-step fp32 solve rtol 5e-4 / atol 5e-5 (128 stages of
that).  bf16 operands: an fp32 sum in another order can move a later bf16
rounding by one place (2^-8 relative), so rtol/atol 2e-2 for a stage and 5e-2
for a solve.

The backward kernels are held per output tensor to ``max|kernel - plain| <=
tol * max|plain|``: a weight gradient is a sum over every row (and, for K4,
every stage), so its small entries are differences of large terms and carry
an absolute error of the size of the largest.  tol: fp32 1e-4 for a stage,
5e-4 for a solve; bf16 3e-2 and 6e-2 (the forward's bf16 bounds, a little
wider for the longer chain).
"""

import pytest
import torch

from continuousnormalizingflows_tpu_torch.models.nets import MLP
import continuousnormalizingflows_tpu_torch as cnf
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
    fused_dynamics_vjp,
    fused_dynamics_vjp_bwd,
    fused_dynamics_vjp_bwd_reference,
    mlp3_forward_vjp_reference,
)
from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
    fused_solve_rk4,
    fused_solve_rk4_bwd,
    fused_solve_rk4_bwd_reference,
    fused_solve_rk4_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(widths, dev, seed=0):
    return MLP(widths).init(torch.Generator().manual_seed(seed), device=dev)


TOL = {None: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
SOLVE_TOL = {None: (5e-4, 5e-5), torch.bfloat16: (5e-2, 5e-2)}


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
# h <= 32 takes the row-per-thread path (h = 20 padded to 24), wider the tiled one
@pytest.mark.parametrize("n_in, h, nz, b", [(6, 24, 5, 1000), (5, 20, 4, 333), (9, 32, 8, 77),
                                            (44, 176, 43, 257), (6, 1024, 5, 19)])
def test_fused_dynamics_kernel_matches_plain(dev, n_in, h, nz, b, cdt):
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    before = fused_dynamics_vjp.launches
    out = fused_dynamics_vjp(x, eps, params, nz, cdt)
    torch.cuda.synchronize()
    assert fused_dynamics_vjp.launches == before + 1
    ref = mlp3_forward_vjp_reference(x, eps, params, nz, cdt)
    rtol, atol = TOL[cdt]
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "case", ["plain", "conditioned", "autonomous", "reversed", "padded", "tabular", "widest"]
)
def test_fused_solve_kernel_matches_plain(dev, case, cdt):
    nz, nc, t_col, span, h, b = 5, 0, 5, (0.0, 1.0), 24, 999
    if case == "conditioned":
        nc = 2
    if case == "autonomous":
        t_col = None
    if case == "reversed":
        span = (torch.tensor(1.07, device=dev), 0.0)
    if case == "padded":  # h = 28 runs as 32 on the row path, with conditions
        nc, h = 3, 28
    if case == "tabular":  # the tiled path
        nz, t_col, h, b = 43, 43, 176, 300
    if case == "widest":  # the gate's limits: h = 512, net input and state 128
        nz, nc, t_col, h, b = 125, 2, 125, 512, 70
    n_in = nz + (0 if t_col is None else 1) + nc
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(2)
    u0 = 0.5 * torch.randn((b, nz + 3), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    ys = torch.randn((b, nc), generator=g, device=dev) if nc else None
    before = fused_solve_rk4.launches
    u1 = fused_solve_rk4(u0, eps, ys, params, span, nz, t_col, 32, cdt)
    torch.cuda.synchronize()
    assert fused_solve_rk4.launches == before + 1
    ref = fused_solve_rk4_reference(u0, eps, ys, params, span, nz, t_col, 32, cdt)
    rtol, atol = SOLVE_TOL[cdt]
    torch.testing.assert_close(u1, ref, rtol=rtol, atol=atol)


BWD_TOL = {None: 1e-4, torch.bfloat16: 3e-2}
SOLVE_BWD_TOL = {None: 5e-4, torch.bfloat16: 6e-2}


def _close_to_max(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), (
            float((a - b).abs().max()), float(b.abs().max()))


def _flat(out):
    xbar, epsbar, wbars = out
    return [xbar, epsbar, *wbars]


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_in, h, nz, b", [(6, 24, 5, 1000), (5, 20, 4, 333), (9, 32, 8, 77),
                                            (44, 176, 43, 257), (6, 1024, 5, 19)])
def test_fused_dynamics_bwd_kernel_matches_plain(dev, n_in, h, nz, b, cdt):
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    cot = (torch.randn((b, nz), generator=g, device=dev),
           torch.randn((b, nz), generator=g, device=dev),
           *torch.randn((3, b), generator=g, device=dev))
    before = fused_dynamics_vjp_bwd.launches
    got = fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)
    torch.cuda.synchronize()
    assert fused_dynamics_vjp_bwd.launches == before + 1
    want = fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot, cdt)
    _close_to_max(_flat(got), _flat(want), BWD_TOL[cdt])


def _solve_case(case, dev):
    nz, nc, t_col, span, h, b = 5, 0, 5, (0.0, 1.0), 24, 999
    if case == "conditioned":
        nc = 2
    if case == "autonomous":
        t_col = None
    if case == "reversed":
        span = (torch.tensor(1.07, device=dev), 0.0)
    if case == "padded":
        nc, h = 3, 28
    if case == "ffjord":  # h = 12, nz = 2: the FFJORD form's net
        nz, t_col, h = 2, 2, 12
    if case == "tabular":
        nz, t_col, h, b = 43, 43, 176, 300
    if case == "widest":
        nz, nc, t_col, h, b = 125, 2, 125, 512, 70
    n_in = nz + (0 if t_col is None else 1) + nc
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(4)
    u0 = 0.5 * torch.randn((b, nz + 3), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    ys = torch.randn((b, nc), generator=g, device=dev) if nc else None
    gbar = torch.randn((b, nz + 3), generator=g, device=dev)
    return (u0, eps, ys, params, span, nz, t_col), gbar


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "case", ["plain", "conditioned", "autonomous", "reversed", "padded", "ffjord", "tabular",
             "widest"]
)
def test_fused_solve_bwd_kernel_matches_plain(dev, case, cdt):
    args, gbar = _solve_case(case, dev)
    steps = 8 if case == "widest" else 32
    before = fused_solve_rk4_bwd.launches
    got = fused_solve_rk4_bwd(*args, steps, gbar, cdt)
    torch.cuda.synchronize()
    assert fused_solve_rk4_bwd.launches == before + 1
    want = fused_solve_rk4_bwd_reference(*args, steps, gbar, cdt)
    _close_to_max(_flat(got), _flat(want), SOLVE_BWD_TOL[cdt])


def test_backward_kernels_are_deterministic(dev):
    """Weight gradients are summed in a fixed order: two calls, same bits."""
    args, gbar = _solve_case("plain", dev)
    first = _flat(fused_solve_rk4_bwd(*args, 32, gbar))
    second = _flat(fused_solve_rk4_bwd(*args, 32, gbar))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    u0, eps, _ys, params, _span, nz, _t = args
    x = torch.cat([u0[:, :nz], torch.full((u0.shape[0], 1), 0.3, device=dev)], dim=-1)
    cot = (gbar[:, :nz], gbar[:, :nz], *gbar[:, nz:].T)
    first = _flat(fused_dynamics_vjp_bwd(x, eps, params, nz, cot))
    second = _flat(fused_dynamics_vjp_bwd(x, eps, params, nz, cot))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("form", ["rnode", "ffjord"])
def test_loss_gradients_flow_through_the_kernels(dev, form):
    """fused=True loss gradients on CUDA tensors (K3 + K4 for the RNODE, K1 +
    K2 per stage for the FFJORD form) against fused=False, same draws."""
    solver = SolverConfig(method="rk4", gradient="backprop", fixed_steps=8)
    kw = dict(naugments=0, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0) if form == "ffjord" else {}
    fused = cnf.ICNF.create(nvariables=2, solver=solver, fused=True, **kw)
    plain = cnf.ICNF.create(nvariables=2, solver=solver, fused=False, **kw)
    params = {k: v.requires_grad_() for k, v in
              fused.init(torch.Generator().manual_seed(0), device=dev).items()}
    x = torch.randn((500, 2), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    counts = (fused_solve_rk4_bwd.launches, fused_dynamics_vjp_bwd.launches)
    grads = {}
    for name, icnf in (("fused", fused), ("plain", plain)):
        gen = torch.Generator(device=dev).manual_seed(2)
        loss = cnf.loss(icnf, Mode.TRAIN, x, params, gen)
        grads[name] = torch.autograd.grad(loss, list(params.values()))
    moved = (fused_solve_rk4_bwd.launches - counts[0], fused_dynamics_vjp_bwd.launches - counts[1])
    assert moved == ((1, 0) if form == "rnode" else (0, 32))
    _close_to_max(grads["fused"], grads["plain"], 5e-4)
