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
from continuousnormalizingflows_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches(*names):
    """The launch counters of the kernels ``names`` (``"K1"`` ... ``"K6"``):
    an int for one name, else a list."""
    c = profiling.counters()
    got = [c.get(f"{n}.launches", 0) for n in names]
    return got[0] if len(names) == 1 else got


def _params(widths, dev, seed=0):
    return MLP(widths).init(torch.Generator().manual_seed(seed), device=dev)


TOL = {None: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
SOLVE_TOL = {None: (5e-4, 5e-5), torch.bfloat16: (5e-2, 5e-2)}

# K3's and K4's least hidden width on their wide paths (kSolveWideMinH in
# csrc/wide_solve.cuh), and the widths of their wide-path tests: h -> nz, a
# conditioned net input (n_in = nz + 3: the time and 2 conditions), nz = 29
# and 125 not multiples of 8, h = 512 at the gate's limits (net input and
# state 128)
SOLVE_WIDE_MIN_H = 64
SOLVE_WIDE_WIDTHS = {64: 20, 128: 29, 176: 43, 256: 64, 512: 125}


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
# h <= 32 takes the row-per-thread path (h = 20 padded to 24), wider the tiled one
@pytest.mark.parametrize("n_in, h, nz, b", [(6, 24, 5, 1000), (5, 20, 4, 333), (9, 32, 8, 77),
                                            (44, 176, 43, 257), (6, 1024, 5, 19)])
def test_fused_dynamics_kernel_matches_plain(dev, n_in, h, nz, b, cdt):
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    before = _launches("K1")
    out = fused_dynamics_vjp(x, eps, params, nz, cdt)
    torch.cuda.synchronize()
    assert _launches("K1") == before + 1
    ref = mlp3_forward_vjp_reference(x, eps, params, nz, cdt)
    rtol, atol = TOL[cdt]
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "case", ["plain", "conditioned", "autonomous", "reversed", "padded", "tabular", "widest",
             "wide-conditioned", "wide-autonomous", "wide-reversed"]
)
def test_fused_solve_kernel_matches_plain(dev, case, cdt):
    nz, nc, t_col, span, h, b = 5, 0, 5, (0.0, 1.0), 24, 999
    if case.startswith("wide-"):  # the wide path at its least width (tabular, widest: wider)
        h, case = SOLVE_WIDE_MIN_H, case[5:]
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
    before = _launches("K3")
    u1 = fused_solve_rk4(u0, eps, ys, params, span, nz, t_col, 32, cdt)
    torch.cuda.synchronize()
    assert _launches("K3") == before + 1
    ref = fused_solve_rk4_reference(u0, eps, ys, params, span, nz, t_col, 32, cdt)
    rtol, atol = SOLVE_TOL[cdt]
    torch.testing.assert_close(u1, ref, rtol=rtol, atol=atol)


# K1 and K3 at every width of their row path (h padded to H, a multiple of 4:
# h = 4 ... 32) and past it (h = 33, the tiled path); the FFJORD form's widths
# at h = 12 (3 -> 12 -> 12 -> 2), a conditioned net input (nz = 5, the time
# and 2 conditions) elsewhere; batches ragged against the 256-row block
FWD_WIDTHS = [4, 8, 12, 16, 20, 24, 28, 32, 33]


def _fwd_widths(h):
    return (3, 2, 0) if h == 12 else (8, 5, 2)  # n_in, nz, conditions


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 257, 1000])
@pytest.mark.parametrize("h", FWD_WIDTHS)
def test_fused_dynamics_row_widths(dev, h, b, cdt):
    from continuousnormalizingflows_tpu_torch.ops import _build

    n_in, nz, _nc = _fwd_widths(h)
    assert _build.plan(n_in, h, nz, nz, 0)[2] == (0 if h > 32 else -(-h // 4) * 4)
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    before = _launches("K1")
    out = fused_dynamics_vjp(x, eps, params, nz, cdt)
    torch.cuda.synchronize()
    assert _launches("K1") == before + 1
    ref = mlp3_forward_vjp_reference(x, eps, params, nz, cdt)
    for a, r in zip(out, ref):
        torch.testing.assert_close(a, r, rtol=TOL[cdt][0], atol=TOL[cdt][1])


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 257, 1000])
@pytest.mark.parametrize("h", FWD_WIDTHS)
def test_fused_solve_row_widths(dev, h, b, cdt):
    """K3 at each width against its plain version, and twice: the same bits."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    n_in, nz, nc = _fwd_widths(h)
    assert _build.plan(n_in, h, nz, nz, nz + 3)[2] == (0 if h > 32 else -(-h // 4) * 4)
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(6)
    u0 = 0.5 * torch.randn((b, nz + 3), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    ys = torch.randn((b, nc), generator=g, device=dev) if nc else None
    span = (0.0, torch.tensor(1.05, device=dev))
    before = _launches("K3")
    u1 = fused_solve_rk4(u0, eps, ys, params, span, nz, nz, 32, cdt)
    torch.cuda.synchronize()
    assert _launches("K3") == before + 1
    ref = fused_solve_rk4_reference(u0, eps, ys, params, span, nz, nz, 32, cdt)
    torch.testing.assert_close(u1, ref, rtol=SOLVE_TOL[cdt][0], atol=SOLVE_TOL[cdt][1])
    assert torch.equal(u1, fused_solve_rk4(u0, eps, ys, params, span, nz, nz, 32, cdt))


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_in, nz", [(3, 2), (6, 5)])
def test_zero_padded_units_give_the_same_bits(dev, n_in, nz, cdt):
    """A net of h = 16 whose units 12-15 have zero weights in and out runs at
    H = 16, the h = 12 net at H = 12: padded units add exact zeros at the end
    of every sum over hidden units, so K1 and K3 give the same bits (and K4's
    trajectory, at the backwards' H = 16, takes K3's states)."""
    small = _params((n_in, 12, 12, nz), dev)
    padded = {}
    for key, v in small.items():
        w = torch.zeros(tuple(16 if d == 12 else d for d in v.shape), device=dev)
        w[tuple(slice(0, d) for d in v.shape)] = v
        padded[key] = w
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((1000, n_in), generator=g, device=dev)
    eps = torch.randn((1000, nz), generator=g, device=dev)
    u0 = 0.5 * torch.randn((1000, nz + 3), generator=g, device=dev)
    span = (0.0, torch.tensor(1.05, device=dev))
    for a, b in zip(fused_dynamics_vjp(x, eps, small, nz, cdt),
                    fused_dynamics_vjp(x, eps, padded, nz, cdt)):
        assert torch.equal(a, b)
    solve = lambda p: fused_solve_rk4(u0, eps, None, p, span, nz, nz, 32, cdt)
    assert torch.equal(solve(small), solve(padded))


def test_gates_within_their_stated_error(dev):
    """stage.cuh's gates (sigmoid and softplus from ex2.approx, rcp.approx
    and a polynomial log1p) over z in [-90, 90], both sides of 0, the
    subnormal range of e^-|z| and the specials, against float64: sigmoid
    within 2.5e-7 absolute; sigmoid and softplus within 6e-7 + 8e-8 |z|
    relative for z < 0 and 6e-7 for z >= 0, wherever the float64 value is a
    normal float (>= 2^-125 here, to stay off the edge); below, results
    flush to zero.  The errors are printed."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    z = torch.cat([torch.linspace(-90.0, 90.0, 2_000_001, dtype=torch.float64),
                   torch.logspace(-45, 2, 20_000, dtype=torch.float64),
                   -torch.logspace(-45, 2, 20_000, dtype=torch.float64),
                   torch.linspace(-104.0, -86.0, 20_001, dtype=torch.float64)]).float().to(dev)
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan")], device=dev)
    z = torch.cat([z, specials])
    sig, sp = torch.empty_like(z), torch.empty_like(z)
    _build.check(_build.kernels().cnf_gates(z.data_ptr(), sig.data_ptr(), sp.data_ptr(),
                                            z.numel(), torch.cuda.current_stream().cuda_stream),
                 "gates")
    torch.cuda.synchronize()
    n = z.numel() - specials.numel()
    # 0, -0 -> (1/2, log 2); inf -> (1, inf); -inf -> (0, 0); nan -> (nan, nan)
    assert sig[n:n + 2].tolist() == [0.5, 0.5] and sig[n + 2:n + 4].tolist() == [1.0, 0.0]
    assert abs(sp[n] - 0.6931471805599453) <= 6e-7 and sp[n] == sp[n + 1]
    assert sp[n + 2:n + 4].tolist() == [float("inf"), 0.0]
    assert bool(sig[-1].isnan()) and bool(sp[-1].isnan())
    z64, sig, sp = z[:n].double(), sig[:n].double(), sp[:n].double()
    e = torch.exp(-z64.abs())
    sig64 = torch.where(z64 >= 0, 1 / (1 + e), e / (1 + e))
    sp64 = z64.clamp_min(0) + torch.log1p(e)
    bound = 6e-7 + 8e-8 * (-z64).clamp_min(0)
    normal = 2.0 ** -125
    err = {}
    for name, got, want in (("sigmoid", sig, sig64), ("softplus", sp, sp64)):
        diff = (got - want).abs()
        big = want >= normal
        rel = diff[big] / want[big]
        err[name] = (float(diff.max()), float(rel.max()), float((rel / bound[big]).max()))
        assert bool((rel <= bound[big]).all()), (name, err[name])
        assert bool((diff[~big] <= normal).all()), name
    assert err["sigmoid"][0] <= 2.5e-7, err
    print(f"gates vs float64: (max abs, max rel, max rel / bound) {err}")


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
    before = _launches("K2")
    got = fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)
    torch.cuda.synchronize()
    assert _launches("K2") == before + 1
    want = fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot, cdt)
    _close_to_max(_flat(got), _flat(want), BWD_TOL[cdt])


# K2's row path at its widths (h = 8, 16, 24 exact; h = 12, the FFJORD form's net
# 3 -> 12 -> 12 -> 2, padded to 16) and the tiled path past it (h = 32, where a
# block of the row path would leave an SM two warps, and h = 33); a conditioned
# net input (nz = 5, the time and 2 conditions: xbar has n_in = 8
# columns), a non-zero ezbar; batches around the 64-row tile, and one longer than
# a full grid of tiles (264 blocks of 64 rows), so that blocks take a second tile
@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 63, 64, 65, 127, 1000, 20000])
@pytest.mark.parametrize("h", [8, 12, 16, 24, 32, 33])
def test_fused_dynamics_bwd_paths_and_edges(dev, h, b, cdt):
    from continuousnormalizingflows_tpu_torch.ops import _build

    n_in, nz = (3, 2) if h == 12 else (8, 5)
    plan = _build.bwd_plan(n_in, h, nz, nz, 0, b)
    assert plan.path == ("row" if h <= 24 else "tiled") and plan.scratch == 0
    assert plan.H == (0 if h > 24 else -(-h // 8) * 8)
    # blocks take tiles in turn: at most what the card holds at once (2-4 blocks
    # on each of 132 SMs by the row path's shared memory, 2 on the tiled path)
    resident = 528 if h == 12 else {0: 264, 8: 528, 16: 396, 24: 264}[plan.H]
    assert plan.grid == min(-(-b // plan.rows), resident)
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    cot = (torch.randn((b, nz), generator=g, device=dev),
           torch.randn((b, nz), generator=g, device=dev),
           *torch.randn((3, b), generator=g, device=dev))
    before = _launches("K2")
    got = fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)
    torch.cuda.synchronize()
    assert _launches("K2") == before + 1
    want = fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot, cdt)
    _close_to_max(_flat(got), _flat(want), BWD_TOL[cdt])


def _check_wide_plan(plan, b, h, nz):
    """K2's wide path: 64-row output tiles, a scratch of at least the fp32
    chain's 10 h + 4 nz floats a row, and the weight-gradient products cut
    into slices of at least 256 batch rows (of 2b) or not at all."""
    assert (plan.path, plan.rows, plan.staged, plan.H) == ("wide", 64, False, 0)
    assert plan.scratch >= b * (10 * h + 4 * nz)
    assert plan.grid == 0 or 1 < plan.grid <= -(-2 * b // 256)


# K2 past its row path: the tiled path just past it (h = 25, 32, 33), the wide
# path from h = 64 (kWideMinH) to the image width (h = 1024, nz = 784), the
# tabular width (176, nz = 43) and h = 100 (its bf16 rows padded to 104)
# between; every net input conditioned (n_in = nz + 3: the time and 2
# conditions), a non-zero ezbar; batches of 1, 7, around the 64-row tile and
# 256-row slices, and 1,000
WIDE_WIDTHS = {25: 5, 32: 8, 33: 9, 64: 20, 100: 30, 176: 43, 256: 64, 1024: 784}  # h: nz


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 7, 255, 256, 257, 1000])
@pytest.mark.parametrize("h", list(WIDE_WIDTHS))
def test_fused_dynamics_bwd_wide_nets(dev, h, b, cdt):
    """Against the plain version at BWD_TOL, the same bits twice, one launch
    counted a call."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    nz = WIDE_WIDTHS[h]
    n_in = nz + 3
    plan = _build.bwd_plan(n_in, h, nz, nz, 0, b)
    if h >= 64:
        _check_wide_plan(plan, b, h, nz)
    else:
        assert plan.path == "tiled"
    params = _params((n_in, h, h, nz), dev, seed=h)
    g = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    cot = (torch.randn((b, nz), generator=g, device=dev),
           torch.randn((b, nz), generator=g, device=dev),
           *torch.randn((3, b), generator=g, device=dev))
    before = _launches("K2")
    got = _flat(fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt))
    again = _flat(fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt))
    torch.cuda.synchronize()
    assert _launches("K2") == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = fused_dynamics_vjp_bwd_reference(x, eps, params, nz, cot, cdt)
    _close_to_max(got, _flat(want), BWD_TOL[cdt])


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_dynamics_bwd_wide_memory(dev, cdt):
    """K2 at the image model (785 -> 1024 -> 1024 -> 784, B = 256) adds under
    64 MB to the device's peak: its outputs and scratch, and no (grid, P)
    buffer of per-block partial gradients, only the 2 slices' partial
    gradients that fp32's 128 x 96 tiles ask for (2 x 2.7 M floats)."""
    n_in, h, nz, b = 785, 1024, 784, 256
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    cot = (torch.randn((b, nz), generator=g, device=dev),
           torch.randn((b, nz), generator=g, device=dev),
           *torch.randn((3, b), generator=g, device=dev))
    fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fused_dynamics_vjp_bwd(x, eps, params, nz, cot, cdt)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < 64 * 2**20
    assert all(torch.isfinite(t).all() for t in _flat(out))


# K1's least hidden width on its wide path (kWideMinH in csrc/fused_dynamics.cu)
K1_WIDE_MIN_H = 64


def _check_fwd_plan(plan, n_in, h, nz, b):
    """K1's plan: the wide path from K1_WIDE_MIN_H (64-row output tiles,
    weights read from device memory, a scratch of at least the fp32 chain's
    4 h floats a row), else cnf::choose's row path (h <= 32 where the
    weights fit) or tiled path."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    choice = _build.plan(n_in, h, nz, nz, 0)
    want = "wide" if h >= K1_WIDE_MIN_H else "row" if choice[2] else "tiled"
    assert plan.path == want, (h, plan)
    if want == "wide":
        assert (plan.rows, plan.staged, plan.H) == (64, False, 0)
        assert plan.scratch >= 4 * b * h
    else:
        assert tuple(plan) == tuple(choice)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 7, 255, 256, 257, 1000])
@pytest.mark.parametrize("h", list(WIDE_WIDTHS))
def test_fused_dynamics_wide_nets(dev, h, b, cdt):
    """K1 past its row path (the widths of K2's test above): the path its plan
    names, against the plain version at TOL, the same bits twice, one launch
    counted a call."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    nz = WIDE_WIDTHS[h]
    n_in = nz + 3
    _check_fwd_plan(_build.fwd_plan(n_in, h, nz, nz, b), n_in, h, nz, b)
    params = _params((n_in, h, h, nz), dev, seed=h)
    g = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    before = _launches("K1")
    got = fused_dynamics_vjp(x, eps, params, nz, cdt)
    again = fused_dynamics_vjp(x, eps, params, nz, cdt)
    torch.cuda.synchronize()
    assert _launches("K1") == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _close_stage(got, mlp3_forward_vjp_reference(x, eps, params, nz, cdt), eps, TOL[cdt])


def _close_stage(got, want, eps, tol):
    """K1's outputs against the plain version's: y, e_z, |y| and |e_z| at
    ``tol`` element by element; div = <e_z, eps>, a sum of nz products, at
    ``tol`` relative to the sum of its terms' magnitudes (the scale of its
    rounding: at nz = 784 two fp32 orders of the sums leading to e_z move a
    div near 0 by up to 2e-5), against the plain version's div and against
    the kernel's own e_z summed in float64."""
    rtol, atol = tol
    for i in (0, 1, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=rtol, atol=atol)
    terms = (want[1] * eps).abs().sum(-1)
    own = (got[1].double() * eps.double()).sum(-1)
    for ref in (want[2], own):
        err = (got[2].double() - ref.double()).abs()
        assert bool((err <= atol + rtol * terms).all()), float(err.max())


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_dynamics_wide_memory(dev, cdt):
    """K1 at the image model (785 -> 1024 -> 1024 -> 784, B = 256) adds under
    32 MB to the device's peak: its outputs, its scratch and the bf16 copies."""
    n_in, h, nz, b = 785, 1024, 784, 256
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, n_in), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    fused_dynamics_vjp(x, eps, params, nz, cdt)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fused_dynamics_vjp(x, eps, params, nz, cdt)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < 32 * 2**20
    assert all(torch.isfinite(t).all() for t in out)


def test_fwd_plan_names_the_path(dev):
    """K1's plan (cnf_fwd_plan) beside cnf::choose's, which K3 keeps short of
    its own wide path: the row path up to h = 32 where the weights fit, the
    wide path from K1_WIDE_MIN_H, the tiled path between and wherever a
    row's weights do not fit the row path short of the wide one; K3 (sd >
    0) wide from SOLVE_WIDE_MIN_H."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    for h, n_in, nz in ((8, 6, 5), (12, 3, 2), (24, 6, 5), (32, 6, 5)):
        _check_fwd_plan(_build.fwd_plan(n_in, h, nz, nz, 1000), n_in, h, nz, 1000)
        assert _build.fwd_plan(n_in, h, nz, nz, 1000).H == -(-h // 4) * 4
    for h in range(33, 65):
        _check_fwd_plan(_build.fwd_plan(6, h, 5, 5, 1000), 6, h, 5, 1000)
        assert _build.plan(6, h, 5, 5, 8)[2] == 0
        assert _build.plan(6, h, 5, 5, 8).path == ("wide" if h >= SOLVE_WIDE_MIN_H else "tiled")
    for n_in, h, nz, b in ((44, 176, 43, 8_192), (65, 256, 64, 256), (785, 1024, 784, 256)):
        plan = _build.fwd_plan(n_in, h, nz, nz, b)
        _check_fwd_plan(plan, n_in, h, nz, b)
        assert _build.plan(n_in, h, nz, nz, nz + 3).path == "wide"
    # the image model's scratch, 9.3 MB: s1, s2, two operand arrays and the
    # bf16 copies of the inputs
    assert _build.fwd_plan(785, 1024, 784, 784, 256).scratch * 4 < 10 * 2**20
    # at n_in = 785 the weights of h = 32 miss the row path: tiled, unless wide
    _check_fwd_plan(_build.fwd_plan(785, 32, 784, 784, 256), 785, 32, 784, 256)


def _solve_case(case, dev):
    nz, nc, t_col, span, h, b = 5, 0, 5, (0.0, 1.0), 24, 999
    if case.startswith("wide-"):  # the wide path at its least width (tabular, widest: wider)
        h, case = SOLVE_WIDE_MIN_H, case[5:]
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
    # the edges of K4's row path: h = 8, 16 (H exact) and 32 (its widest), h = 33
    # (the tiled path), and batches of 1, 127 and 129 rows (ragged blocks of 64)
    if case in ("h8", "h16", "h32", "h33"):
        h = int(case[1:])
    if case in ("b1", "b127", "b129"):
        b = int(case[1:])
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
             "widest", "h8", "h16", "h32", "h33", "b1", "b127", "b129", "wide-conditioned",
             "wide-autonomous", "wide-reversed"]
)
def test_fused_solve_bwd_kernel_matches_plain(dev, case, cdt):
    args, gbar = _solve_case(case, dev)
    steps = 8 if case == "widest" else 32
    before = _launches("K4")
    got = fused_solve_rk4_bwd(*args, steps, gbar, cdt)
    torch.cuda.synchronize()
    assert _launches("K4") == before + 1
    want = fused_solve_rk4_bwd_reference(*args, steps, gbar, cdt)
    _close_to_max(_flat(got), _flat(want), SOLVE_BWD_TOL[cdt])


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b", [1, 7, 255, 256, 257, 1000])
@pytest.mark.parametrize("h", list(SOLVE_WIDE_WIDTHS))
def test_fused_solve_wide_nets(dev, h, b, cdt):
    """K3 and K4 on their wide paths, 6 steps over a span that ends at a
    device scalar: the path their plans name, each against its plain version
    (SOLVE_TOL, SOLVE_BWD_TOL), the same bits twice, one launch counted a
    call."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    nz = SOLVE_WIDE_WIDTHS[h]
    n_in = sd = nz + 3
    assert _build.plan(n_in, h, nz, nz, sd, b).path == "wide"
    assert _build.bwd_plan(n_in, h, nz, nz, sd, b).path == "wide"
    params = _params((n_in, h, h, nz), dev, seed=h)
    g = torch.Generator(device=dev).manual_seed(b)
    u0 = 0.5 * torch.randn((b, sd), generator=g, device=dev)
    eps = torch.randn((b, nz), generator=g, device=dev)
    ys = torch.randn((b, 2), generator=g, device=dev)
    gbar = torch.randn((b, sd), generator=g, device=dev)
    args = (u0, eps, ys, params, (0.0, torch.tensor(1.05, device=dev)), nz, nz, 6)
    before = (_launches("K3"), _launches("K4"))
    u1, again = fused_solve_rk4(*args, cdt), fused_solve_rk4(*args, cdt)
    got = _flat(fused_solve_rk4_bwd(*args, gbar, cdt))
    twice = _flat(fused_solve_rk4_bwd(*args, gbar, cdt))
    torch.cuda.synchronize()
    assert (_launches("K3"), _launches("K4")) == (before[0] + 2,
                                                                        before[1] + 2)
    assert torch.equal(u1, again) and all(torch.equal(a, c) for a, c in zip(got, twice))
    torch.testing.assert_close(u1, fused_solve_rk4_reference(*args, cdt), rtol=SOLVE_TOL[cdt][0],
                               atol=SOLVE_TOL[cdt][1])
    _close_to_max(got, _flat(fused_solve_rk4_bwd_reference(*args, gbar, cdt)), SOLVE_BWD_TOL[cdt])


# The fp32 product core's tiles (csrc/wide_gemm.cuh): index 0 128 x 96, 1 64 x
# 96, 2 the first design's 64 x 32.  Products at the d43 cell's shapes (88 ->
# 352 -> 352 -> 87, B = 8,192): a (M, N, K) of each kind, both layouts of
# each operand, rows of 87 floats (not 16-byte aligned), a weight gradient of
# two row sets with a ragged extent, cut into slices, and M = 8,193 and 256.
def _f32_case(case, dev):
    g = torch.Generator(device=dev).manual_seed(7)
    b, h, n_in, nz = 8192, 352, 88, 87
    if case == "m8193":
        b = 8193
    if case == "b256":
        b = 256

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x, hid, d, eb = r(b, n_in), r(b, h), r(b, h), r(b, nz)
    a1, a2, a3 = r(h, n_in), r(h, h), r(nz, h)
    row = lambda t, ext: (t, ext, None, ext, True)  # noqa: E731
    col = lambda t, ext: (t, ext, None, ext, False)  # noqa: E731
    cases = {
        "n352k352": (row(hid, b), row(a2, h), b, h, h),
        "n352k352_bycol": (row(d, b), col(a2, h), b, h, h),
        "n352k88": (row(x, b), row(a1, h), b, h, n_in),
        "n352k87_ld87": (row(eb, b), row(a1, h), b, h, nz),
        "n87k352": (row(hid, b), row(a3, nz), b, nz, h),
        "n87k352_bycol": (row(d, b), col(a1, nz), b, nz, h),
        "m8193": (row(hid, b), row(a2, h), b, h, h),
        "b256": (row(hid, b), col(a2, h), b, h, h),
        "bycol_byrow": (col(hid, h), row(a2, h), h, h, h),
    }
    if case == "wgrad":  # dA1 = z1^T x + d1^T [ebar, 0], cut into 3 slices
        a = (hid, 300, d, 200, False)
        bb = (x, 80, eb, nz, False)
        return a, bb, h, n_in, 2 * b, b, 3
    a, bb, m, n, k = cases[case]
    return a, bb, m, n, k, 1 << 30, 1


F32_CASES = ["n352k352", "n352k352_bycol", "n352k88", "n352k87_ld87", "n87k352",
             "n87k352_bycol", "wgrad", "m8193", "b256", "bycol_byrow"]


@pytest.mark.parametrize("case", F32_CASES)
def test_wide_f32_tiles_give_the_first_designs_bits(dev, case):
    """Each Hopper tile of the fp32 core gives the 64 x 32 tile's bits (every
    output adds the same terms in the same order), on the same product
    through the test entry, call after call; the 64 x 32 tile against a
    float64 product."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    a, b, m, n, k, kseg, slices = _f32_case(case, dev)
    first = _build.wide_f32_product(2, a, b, m, n, k, kseg, slices)
    for tile in (0, 1, 0, 1):
        assert torch.equal(_build.wide_f32_product(tile, a, b, m, n, k, kseg, slices), first)
    assert torch.equal(_build.wide_f32_product(-1, a, b, m, n, k, kseg, slices), first)

    def dense(op, f):  # the operand as an (f, k) float64 matrix
        t0, e0, t1, e1, kmajor = op
        parts = []
        for t, e, rows in ((t0, e0, min(k, kseg)), (t1, e1, k - min(k, kseg))):
            if rows <= 0:
                continue
            t = (t0 if t is None else t).double()
            v = torch.zeros((f, rows), dtype=torch.float64, device=dev)
            c = min(f, e)
            v[:c] = t[:c, :rows] if kmajor else t[:rows, :c].T
            parts.append(v)
        return torch.cat(parts, dim=1)

    want = dense(a, m) @ dense(b, n).T
    torch.testing.assert_close(first.double().sum(0), want, rtol=1e-5, atol=1e-3)


def test_wide_f32_tiles_follow_the_products_shape(dev):
    """K3 and K4 on their fp32 wide paths at the d43 widths count each product
    on its tile (wide.f32.*): at B = 8,192 the Hopper tiles (the 352-wide
    products on 128 x 96, the 87-wide on 64 x 96) and none on 64 x 32; at B =
    256 the first design's 64 x 32 only."""
    counts = {}
    for b in (8192, 256):
        args, gbar = _d43_solve(dev, b)
        before = profiling.counters()
        fused_solve_rk4(*args, 1)
        fused_solve_rk4_bwd(*args, 1, gbar)
        torch.cuda.synchronize()
        after = profiling.counters()
        counts[b] = {s: after.get(f"wide.f32.{s}", 0) - before.get(f"wide.f32.{s}", 0)
                     for s in ("128x96", "64x96", "64x32")}
    assert counts[8192]["128x96"] > 0 and counts[8192]["64x96"] > 0
    assert counts[8192]["64x32"] == 0
    assert counts[256]["128x96"] == counts[256]["64x96"] == 0 and counts[256]["64x32"] > 0
    # the same products at either batch, on other tiles
    assert sum(counts[8192].values()) == sum(counts[256].values())


def _d43_solve(dev, b):
    """The d43 cell's net (88 -> 352 -> 352 -> 87, a time column, state 90)
    and a batch of b rows over a span that ends at a device scalar."""
    nz, h = 87, 352
    params = _params((nz + 1, h, h, nz), dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(b)
    u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                    torch.zeros((b, 3), device=dev)], dim=-1)
    eps = torch.randn((b, nz), generator=g, device=dev)
    gbar = torch.randn((b, nz + 3), generator=g, device=dev)
    return (u0, eps, None, params, (0.0, torch.tensor(1.05, device=dev)), nz, nz), gbar


def test_fused_solve_d43_widths(dev):
    """K3 and K4 at the d43 cell's widths and batch (B = 8,192, fp32, 4
    steps: the Hopper tiles, the weight gradients cut into the slices of
    their tile) against their plain versions (SOLVE_TOL, SOLVE_BWD_TOL), the
    same bits call after call."""
    args, gbar = _d43_solve(dev, 8192)
    u1, again = fused_solve_rk4(*args, 4), fused_solve_rk4(*args, 4)
    got = _flat(fused_solve_rk4_bwd(*args, 4, gbar))
    twice = _flat(fused_solve_rk4_bwd(*args, 4, gbar))
    torch.cuda.synchronize()
    assert torch.equal(u1, again) and all(torch.equal(a, c) for a, c in zip(got, twice))
    torch.testing.assert_close(u1, fused_solve_rk4_reference(*args, 4), rtol=SOLVE_TOL[None][0],
                               atol=SOLVE_TOL[None][1])
    _close_to_max(got, _flat(fused_solve_rk4_bwd_reference(*args, 4, gbar)), SOLVE_BWD_TOL[None])


@pytest.mark.parametrize("cdt", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_solve_wide_memory(dev, cdt):
    """K3 and K4 at the digits-shaped fit (65 -> 256 -> 256 -> 64, B = 256,
    rk4-24) add under 8 MB (K3: its output and scratch) and 16 MB (K4: its
    outputs, scratch, trajectory and the slices' partial gradients) to the
    device's peak."""
    nz, h, b = 64, 256, 256
    n_in = nz + 1
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(3)
    u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                    torch.zeros((b, 3), device=dev)], dim=-1)
    eps = torch.randn((b, nz), generator=g, device=dev)
    gbar = torch.randn((b, nz + 3), generator=g, device=dev)
    args = (u0, eps, None, params, (0.0, 1.0), nz, nz, 24)
    for fn, limit in ((lambda: [fused_solve_rk4(*args, cdt)], 8),
                      (lambda: _flat(fused_solve_rk4_bwd(*args, gbar, cdt)), 16)):
        fn()  # builds the kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(dev) - base < limit * 2**20
        assert all(torch.isfinite(t).all() for t in out)


# K2's and K4's row path, then their tiled path; K6's walk on its row path (h = 24),
# then on its tiled path (h = 128)
@pytest.mark.parametrize("case", ["plain", "tabular"])
def test_backward_kernels_are_deterministic(dev, case):
    """Weight gradients are summed in a fixed order: two calls, same bits."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    args, gbar = _solve_case(case, dev)
    first = _flat(fused_solve_rk4_bwd(*args, 32, gbar))
    second = _flat(fused_solve_rk4_bwd(*args, 32, gbar))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    u0, eps, _ys, params, _span, nz, _t = args
    x = torch.cat([u0[:, :nz], torch.full((u0.shape[0], 1), 0.3, device=dev)], dim=-1)
    cot = (gbar[:, :nz], gbar[:, :nz], *gbar[:, nz:].T)
    first = _flat(fused_dynamics_vjp_bwd(x, eps, params, nz, cot))
    second = _flat(fused_dynamics_vjp_bwd(x, eps, params, nz, cot))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    args, gbar = _adaptive_case("flagship" if case == "plain" else "wide", dev)
    first = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    second = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    assert all(torch.equal(a, b) for a, b in zip((first[0], first[1], *first[2], first[3]),
                                                 (second[0], second[1], *second[2], second[3])))


def test_bwd_plan_names_the_path(dev):
    """K4 (sd > 0) and K6's walk take the row-per-thread path for h <= 32,
    K2 (sd = 0) for h <= 24: one row a thread in blocks of 64, h padded to a
    multiple of 8 (K5 and K6's replay: of 4); wider nets the tiled path, K2
    from h = 64 its wide path.  K2's blocks take tiles in turn (at most what
    the card holds at once); K4's and K6's grids have a block for every 64
    rows, K6's within a control group (a 72-row group: a 64-row block and an
    8-row one)."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    for h, n_in, nz in ((8, 6, 5), (12, 3, 2), (16, 8, 5), (24, 6, 5), (28, 9, 5), (32, 6, 5)):
        h_pad = -(-h // 8) * 8
        rows, staged, grid, n_params, got_h = _build.bwd_plan(n_in, h, nz, nz, nz + 3, 1000)[:5]
        assert (rows, staged, grid, got_h) == (64, True, 16, h_pad), h
        assert n_params == h * n_in + h + h * h + h + nz * h + nz
        k2 = _build.bwd_plan(n_in, h, nz, nz, 0, 1000)
        if h <= 24:
            assert k2 == (64, True, 16, n_params, h_pad, 0) and k2.path == "row"
            # 4, 4, 3 and 2 blocks of these widths fit an SM's shared memory
            assert _build.bwd_plan(n_in, h, nz, nz, 0, 65_536)[2] == {8: 528, 12: 528, 16: 396,
                                                                      24: 264}[h]
        else:
            assert k2[1:] == (True, -(-1000 // k2[0]), n_params, 0, 0) and k2.path == "tiled"
        for group, blocks in ((8, 1), (64, 1), (72, 2), (128, 2)):
            plan = _build.adaptive_plan(n_in, h, nz, nz, nz + 3, group)
            # K5 and K6's replay pad h to a multiple of 4, K6's walk to one of 8
            assert plan[0] == -(-h // 4) * 4, (h, group)
            assert plan[3] == 64 and plan[5:] == (h_pad, blocks), (h, group)
            # shared memory of a walk block: two blocks an SM up to h = 24
            assert 0 < plan[4] <= (113 if h <= 24 else 227) * 1024
    for sd in (0, 8):
        assert _build.bwd_plan(6, 33, 5, 5, sd, 1000)[4] == 0
        assert _build.bwd_plan(44, 176, 43, 43, 46 if sd else 0, 1000)[4] == 0
    # K2 takes its wide path from h = 64; at 6 -> 64 -> 64 -> 5 and B = 1,000 the
    # weight gradients' 5 output tiles are cut into 8 slices of 256 batch rows
    assert _build.bwd_plan(6, 63, 5, 5, 0, 1000).path == "tiled"
    n_params = 64 * 6 + 64 + 64 * 64 + 64 + 5 * 64 + 5
    _check_wide_plan(_build.bwd_plan(6, 64, 5, 5, 0, 1000), 1000, 64, 5)
    assert _build.bwd_plan(6, 64, 5, 5, 0, 1000)[:5] == (64, False, 8, n_params, 0)
    assert _build.bwd_plan(44, 176, 43, 43, 0, 1000).path == "wide"
    # K3 and K4 take their wide paths from SOLVE_WIDE_MIN_H, the tiled path
    # below: 64-row output tiles, K2's slices of the batch, a scratch of at
    # least the fp32 chains' floats a row
    for h in (33, 48, 63):
        assert _build.bwd_plan(6, h, 5, 5, 8, 1000).path == "tiled"
        assert _build.plan(6, h, 5, 5, 8, 1000).path == "tiled"
    for h, b in ((64, 1000), (176, 8_192), (256, 256), (512, 65_536)):
        nz = SOLVE_WIDE_WIDTHS[h]
        n_in = nz + 3
        k4 = _build.bwd_plan(n_in, h, nz, nz, nz + 3, b)
        assert (k4.path, k4.rows, k4.staged, k4.H) == ("wide", 64, False, 0)
        assert k4.grid == _build.bwd_plan(n_in, h, nz, nz, 0, b).grid
        assert k4.scratch >= b * (13 * h + 9 * nz)
        k3 = _build.plan(n_in, h, nz, nz, nz + 3, b)
        assert (k3.path, k3.rows, k3.staged, k3.H) == ("wide", 64, False, 0)
        assert k3.scratch >= b * 6 * h
    for h in (33, 128):
        plan = _build.adaptive_plan(6, h, 5, 5, 8, 128)
        assert plan[0] == 0 and plan[5:] == (0, 1) and plan[3] > 0
        # where K5 and K6 take the cluster path (test_cluster_plan_picks_and_fits): a
        # cluster a group, whose walk writes one row of partial sums a group
        assert _build.cluster_plan(6, h, 5, 5, 8, 128, 8192).cluster in (2, 4)


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
    counts = (_launches("K4"), _launches("K2"))
    grads = {}
    for name, icnf in (("fused", fused), ("plain", plain)):
        gen = torch.Generator(device=dev).manual_seed(2)
        loss = cnf.loss(icnf, Mode.TRAIN, x, params, gen)
        grads[name] = torch.autograd.grad(loss, list(params.values()))
    moved = (_launches("K4") - counts[0], _launches("K2") - counts[1])
    assert moved == ((1, 0) if form == "rnode" else (0, 32))
    _close_to_max(grads["fused"], grads["plain"], 5e-4)


# ---- K5 / K6: the adaptive whole solve and its backward ----
#
# Per control group of 128 rows the kernel and its plain version run the same
# controller, but a group's step sequence can part where a decision sits on
# a rounding edge: an error ratio within float32 rounding of 1.0, or a step
# factor that decides whether a step reaches t1.  At the random init the
# h = 128 field is so smooth that the error ratios of its first trials from
# the fixed start are float32 rounding (about 1e-6 and 1e-5, against 1e-13
# and 1e-8 in float64): whether the third step reaches t1 turns on that
# rounding in every group alike, and equal step counts still carry step
# sizes that differ by it, so u1 moves by O(tol) (chip_smoke.py's step survey
# shows it).  So the h = 128 case doubles the weights, starts at half the
# span (every ratio resolved: float32 and float64 within 1e-3) and spreads
# the groups over draw scales of 0.1-10 (each group its own steps), on three
# seeds.  The step statistics are compared first: at most one group
# in 16 may take other steps, with at most one accepted step more or less and
# u1 within 1e-3 (ten times the solve tolerance); the groups whose statistics
# agree are held to rtol 2e-4 / atol 2e-5 for u1 (a few fp32 dopri5 steps,
# sums in another order), and the backward per tensor to 5e-4 of its largest
# entry, as K4, with the cotangent zero on the groups of other steps so the
# weight gradients sum over groups of equal steps.  K6's replay must take
# K5's steps in every group: that is the same code on the card.

ADAPTIVE_SCFG = (1e-4, 1e-4, 0.01, 0.9, 0.2, 10.0, 16_384)


def _adaptive_case(case, dev, seed=5, h=24, b=2048, resolved=False, nz=5, nc=0):
    t_col, span = nz, (0.0, torch.tensor(1.05, device=dev))
    if case == "conditioned":
        nc = 2
    if case == "reversed":
        span = (torch.tensor(1.05, device=dev), 0.0)
    if case == "wide":  # h = 128 takes the tiled path, the gate's widest hidden layer
        h, b = 128, 8192
    if case == "small":  # one group of 16 rows
        b = 16
    if case == "two blocks":  # one group of 72 rows: two blocks of K6's walk
        b = 72
    n_in = nz + 1 + nc
    params = _params((n_in, h, h, nz), dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                    torch.zeros((b, 3), device=dev)], dim=-1)
    eps = torch.randn((b, nz), generator=g, device=dev)
    scfg = ADAPTIVE_SCFG
    if h > 32 or resolved:  # every error ratio resolved in float32: see the note above
        group = min(b, 128)
        params = {k: 2.0 * v for k, v in params.items()}
        u0 = u0 * torch.logspace(-1, 1, b // group, device=dev).repeat_interleave(group)[:, None]
        scfg = ADAPTIVE_SCFG[:2] + (0.5,) + ADAPTIVE_SCFG[3:]
    ys = torch.randn((b, nc), generator=g, device=dev) if nc else None
    gbar = torch.randn((b, nz + 3), generator=g, device=dev)
    return (u0, eps, ys, params, span, nz, t_col, scfg), gbar


def _check_adaptive_kernels(args, gbar, seed=None):
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    group = fa.fused_adaptive_tile(args[0].shape[0])
    before = _launches("K5")
    u1, rows = fa.fused_solve_dopri5(*args, 64)
    torch.cuda.synchronize()
    assert _launches("K5") == before + 1
    u1_p, rows_p = fa.fused_solve_dopri5_reference(*args, group)
    same = (rows[:, :3] == rows_p[:, :3]).all(dim=1)
    other = (~same).repeat_interleave(group)
    assert int((~same).sum()) * 16 <= rows.shape[0], seed
    assert bool(((rows[:, 1] - rows_p[:, 1]).abs() <= 1).all())
    torch.testing.assert_close(u1[other], u1_p[other], rtol=1e-3, atol=1e-3)
    keep = same.repeat_interleave(group)
    torch.testing.assert_close(u1[keep], u1_p[keep], rtol=2e-4, atol=2e-5)
    gbar = torch.where(keep[:, None], gbar, torch.zeros_like(gbar))
    before = _launches("K6")
    got = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    torch.cuda.synchronize()
    assert _launches("K6") == before + 1
    # K6's replay took K5's steps in every group
    assert torch.equal(got[3], rows[:, 1].to(torch.int32))
    want = fa.fused_solve_dopri5_bwd_reference(*args, 64, gbar, group)
    _close_to_max([got[0][keep], got[1][keep], *got[2]],
                  [want[0][keep], want[1][keep], *want[2]], 5e-4)
    again = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    assert all(torch.equal(a, b) for a, b in zip((got[0], got[1], *got[2], got[3]),
                                                 (again[0], again[1], *again[2], again[3])))


@pytest.mark.parametrize("case", ["flagship", "conditioned", "reversed", "wide", "small"])
def test_fused_adaptive_kernels_match_plain(dev, case):
    for seed in ((1, 2, 5) if case == "wide" else (5,)):
        args, gbar = _adaptive_case(case, dev, seed)
        _check_adaptive_kernels(args, gbar, seed)


# K6's walk on its row path (h = 8, 24, 32: 64-row blocks, one row a thread) and,
# with K5, on the cluster path (h = 33, 64, 96, 128: a thread-block cluster a
# group, each CTA walking its rows), on groups of 8 rows (one ragged block; a
# cluster of 2 CTAs of 4 rows), 72 (a 64-row block and an 8-row one; 2 CTAs of
# 36 rows), 120 (2 blocks; 2 CTAs of 60 rows), 128 (two blocks) and 3 x 128
@pytest.mark.parametrize("case", ["conditioned", "reversed"])
@pytest.mark.parametrize("b", [8, 72, 120, 128, 384])
@pytest.mark.parametrize("h", [8, 24, 32, 33, 64, 96, 128])
def test_fused_adaptive_walk_paths_and_groups(dev, h, b, case):
    """With one or three groups, a single group whose accept decision sits on
    a rounding edge (K5 and its plain version part, see the note above) would
    leave too little to compare: the draw is the first of four seeds on which
    K5 and the plain version take the same steps in every group."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    group = fa.fused_adaptive_tile(b)
    for seed in (5, 6, 7, 8):
        args, gbar = _adaptive_case(case, dev, seed, h=h, b=b)
        rows = fa.fused_solve_dopri5(*args, 64)[1]
        rows_p = fa.fused_solve_dopri5_reference(*args, group)[1]
        if bool((rows[:, :3] == rows_p[:, :3]).all()):
            break
    else:
        pytest.fail("no draw of four on which K5 and its plain version take the same steps")
    _check_adaptive_kernels(args, gbar, seed)


def _k5_matches_plain(args, seed=None):
    """K5 against its plain version under the rule above: steps first (at
    most one group in 16 differs, by at most one accepted step), then u1 on
    the groups of equal steps.  Returns K5's (u1, stats)."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    group = fa.fused_adaptive_tile(args[0].shape[0])
    u1, rows = fa.fused_solve_dopri5(*args, 64)
    u1_p, rows_p = fa.fused_solve_dopri5_reference(*args, group)
    same = (rows[:, :3] == rows_p[:, :3]).all(dim=1)
    assert int((~same).sum()) * 16 <= rows.shape[0], seed
    assert bool(((rows[:, 1] - rows_p[:, 1]).abs() <= 1).all()), seed
    keep = same.repeat_interleave(group)
    torch.testing.assert_close(u1[keep], u1_p[keep], rtol=2e-4, atol=2e-5)
    return u1, rows


# K5's row path at every H it instantiates (h = 4 ... 32, padded to a multiple
# of 4) and its cluster path past it (h = 33, 64, 96, 128), on one group of 8,
# 72 and 120 rows and on 16 groups of 128.  Every width takes the draw whose error ratios
# float32 resolves (the h = 128 draw of the note above): at h = 32 the random
# init's first trials from the fixed start are float32 rounding, and the plain
# version itself takes other steps in float32 than in float64 in 9-10 of 16
# groups.  A single group takes the first of four draws on which K5 and its
# plain version take the same steps.
@pytest.mark.parametrize("b", [8, 72, 120, 2048])
@pytest.mark.parametrize("h", [4, 8, 12, 16, 20, 24, 28, 32, 33, 64, 96, 128])
def test_fused_adaptive_fwd_widths_and_groups(dev, h, b):
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    group = fa.fused_adaptive_tile(b)
    for seed in ((5,) if b > 128 else (5, 6, 7, 8)):
        args, _gbar = _adaptive_case("flagship", dev, seed, h=h, b=b, resolved=True)
        rows = fa.fused_solve_dopri5(*args, 64)[1]
        rows_p = fa.fused_solve_dopri5_reference(*args, group)[1]
        if b > 128 or bool((rows[:, :3] == rows_p[:, :3]).all()):
            break
    else:
        pytest.fail("no draw of four on which K5 and its plain version take the same steps")
    _k5_matches_plain(args, seed)


@pytest.mark.parametrize("h", [12, 24, 33])
def test_fused_adaptive_fwd_is_deterministic(dev, h):
    """K5 twice on the same inputs: the same bits in u1 and in the stats."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    args, _gbar = _adaptive_case("flagship", dev, h=h)
    first = fa.fused_solve_dopri5(*args, 64)
    second = fa.fused_solve_dopri5(*args, 64)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, second))


# The cluster path (32 < h <= 128, csrc/cluster_adaptive.cuh): the plan, and
# the kernels against the plain versions and against the tiled path it
# replaces (fused_adaptive._WIDE_PATH forces one).  The JAX package's adaptive
# band (benchmarks/adaptive_band.py: ICNFConfig(nvariables=20), 42 -> 128 ->
# 128 -> 41, state 44) at B = 2,048; the gate's edge (n_in = state = 128,
# nz = 125), where the weights do not fit beside a CTA's rows and the products
# read them from device memory, on one group (a second group's draw, scaled
# 10x, takes 16 steps of a 128-wide state, past the few steps the u1
# tolerance is stated for: its u1 differs from the plain version's by up to
# 9e-5 in the tiled path's bits too); and batches with fewer groups than a
# wave of clusters holds and with more.  The plan takes 2 CTAs a group where
# a CTA's 64 rows fit and 4 at the gate's edge, where they do not; each size
# that fits runs at every case (test_cluster_path_matches_plain_and_tiled).
CLUSTER_CASES = {  # (n_in, h, nz, nc, B): (CTAs a group the plan picks, weights resident in K5)
    "band": ((42, 128, 41, 0, 2048), (2, False)),
    "band 21 -> 20": ((21, 128, 20, 0, 2048), (2, False)),
    "gate edge": ((128, 128, 125, 2, 128), (4, False)),
    "h128 64 groups": ((6, 128, 5, 0, 8192), (2, True)),
    "h33 64 groups": ((6, 33, 5, 0, 8192), (2, True)),
    "h33 512 groups": ((6, 33, 5, 0, 65_536), (2, True)),
}


def test_cluster_plan_picks_and_fits(dev):
    """The plan of K5 and K6 above the row path: a cluster of 2 or 4 CTAs a
    group, each with group / CTAs rows, within the 227 KB a CTA may hold; the
    weight image's floats a multiple of 4 x CTAs (each CTA's bulk copy a
    multiple of 16 bytes); K6's share of the weight gradient covers the
    parameters over the cluster; the tiled path where it is asked for, and
    each cluster size where it is asked for and fits."""
    from continuousnormalizingflows_tpu_torch.ops import _build

    for (n_in, h, nz, _nc, b), (cluster, res) in CLUSTER_CASES.values():
        plan = _build.cluster_plan(n_in, h, nz, nz, nz + 3, 128, b)
        assert (plan.cluster, plan.res_fwd) == (cluster, res), (n_in, h, nz, b, plan)
        assert plan.rows * plan.cluster == 128 and 0 < plan.walk_rows <= plan.rows
        assert 0 < plan.smem_fwd <= 227 * 1024 and 0 < plan.smem_bwd <= 227 * 1024
        assert plan.image % (4 * plan.cluster) == 0 and (plan.image > 0) == (
            plan.res_fwd or plan.res_bwd)
        n_params = h * n_in + h + h * h + h + nz * h + nz
        assert plan.share * plan.cluster >= n_params
        assert _build.cluster_plan(n_in, h, nz, nz, nz + 3, 128, b, 0).cluster == 0
        for c in (2, 4):
            assert _build.cluster_plan(n_in, h, nz, nz, nz + 3, 128, b, c).cluster in (0, c)
        assert _build.cluster_plan(n_in, h, nz, nz, nz + 3, 128, b, cluster) == plan
    for h in (8, 24, 32):  # the row paths
        assert _build.cluster_plan(6, h, 5, 5, 8, 128, 8192, 1).cluster == 0
    for g in (8, 72, 120):  # one group: 2 CTAs of g / 2 rows
        assert _build.cluster_plan(6, 128, 5, 5, 8, g, g)[:2] == (2, g // 2)
    assert _build.cluster_plan(128, 128, 125, 125, 128, 128, 128, 2).cluster == 0


@pytest.mark.parametrize("name", list(CLUSTER_CASES))
def test_cluster_path_matches_plain_and_tiled(dev, name):
    """K5 and K6 on the cluster path against their plain versions (the rule
    of _check_adaptive_kernels: steps first, then values, the backward per
    tensor to 5e-4 of its largest entry, the replay's steps, two calls' bits);
    K5 gives the tiled path's bits (the same arithmetic per element, the
    group's error sum in the same order), and K6 the tiled path's gradients to
    1e-5 of their largest entry (the weight gradient summed over rows in
    another grouping); so does each cluster size that fits, where the plan
    would take the other."""
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    (n_in, h, nz, nc, b), _ = CLUSTER_CASES[name]
    args, gbar = _adaptive_case("flagship", dev, 5, h=h, b=b, resolved=True, nz=nz, nc=nc)
    assert args[3]["layers.0.weight"].shape[1] == n_in
    _check_adaptive_kernels(args, gbar)
    u1, rows = fa.fused_solve_dopri5(*args, 64)
    got = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    try:
        fa._WIDE_PATH = "tiled"
        u1_t, rows_t = fa.fused_solve_dopri5(*args, 64)
        want = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    finally:
        fa._WIDE_PATH = None
    assert torch.equal(u1.view(torch.int32), u1_t.view(torch.int32)) and torch.equal(rows, rows_t)
    assert torch.equal(got[3], want[3])
    _close_to_max([got[0], got[1], *got[2]], [want[0], want[1], *want[2]], 1e-5)
    for c in (2, 4):
        if not _build.cluster_plan(n_in, h, nz, nz, nz + 3, 128, b, c).cluster:
            continue
        try:
            fa._WIDE_PATH = f"cluster{c}"
            u1_c, rows_c = fa.fused_solve_dopri5(*args, 64)
            got_c = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
        finally:
            fa._WIDE_PATH = None
        assert torch.equal(u1_c.view(torch.int32), u1_t.view(torch.int32)), c
        assert torch.equal(rows_c, rows_t) and torch.equal(got_c[3], want[3]), c
        _close_to_max([got_c[0], got_c[1], *got_c[2]], [want[0], want[1], *want[2]], 1e-5)


# K6 on the cluster path where K5 holds the weight image and K6's walk does
# not: the same bits call after call, at B = 65,536 (512 groups, many waves
# of clusters), the band's widths with C = 4 and the h = 128 net with C = 2
# (the plan's choice there).  A walk that wrote over the image's mbarrier
# gave NaN in one row's buffer in 1-5 % of such calls.
REPEAT_CASES = {"band C=4": ((42, 128, 41, 65_536), 4), "h128 C=2": ((6, 128, 5, 65_536), 2)}
REPEAT_CALLS = 200


@pytest.mark.parametrize("name", list(REPEAT_CASES))
def test_cluster_bwd_gives_its_bits_call_after_call(dev, name):
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    (n_in, h, nz, b), c = REPEAT_CASES[name]
    plan = _build.cluster_plan(n_in, h, nz, nz, nz + 3, 128, b, c)
    assert plan.cluster == c and plan.res_fwd, plan
    if c == 4:
        assert not plan.res_bwd, plan
    args, gbar = _adaptive_case("flagship", dev, 5, h=h, b=b, resolved=True, nz=nz)
    assert args[3]["layers.0.weight"].shape[1] == n_in
    bits = lambda o: [t.view(torch.int32) if t.dtype == torch.float32 else t
                      for t in (o[0], o[1], *o[2], o[3])]
    try:
        fa._WIDE_PATH = f"cluster{c}"
        first = bits(fa.fused_solve_dopri5_bwd(*args, 64, gbar))
        assert all(torch.isfinite(t.view(torch.float32)).all() for t in first[:-1])
        other = 0
        for _ in range(REPEAT_CALLS):
            got = bits(fa.fused_solve_dopri5_bwd(*args, 64, gbar))
            other += not all(torch.equal(a, b) for a, b in zip(got, first))
    finally:
        fa._WIDE_PATH = None
    assert other == 0, f"{other} of {REPEAT_CALLS} calls gave other bits"


# K6 from K5's record (the cluster path: K5 writes each accepted step's six
# stage inputs where its solve will be taken back, and K6 walks them) against
# K6 given no record (fused_solve_dopri5_bwd: K5's kernel writes one first in
# the call, the same cl_solve): the same bits in u0bar, epsbar, the weight
# gradient and the accepted counts, on every cluster case and at the d8
# cell's widths (18 -> 72 -> 72 -> 17, state 20: 2 CTAs a group, the walk in
# 2 passes of 32 rows)
RECORD_CASES = {**{name: spec for name, (spec, _) in CLUSTER_CASES.items()},
                "d8 2048": (18, 72, 17, 0, 2048), "d8 65536": (18, 72, 17, 0, 65_536)}


def _record_counts():
    c = profiling.counters()
    return c.get("K6.from_record", 0), c.get("K6.replays", 0)


def _from_record(args, gbar, max_nodes=64):
    """K5 asked for its record, then K6 on it: ``(stats rows, the record, K6's
    result)``; K6 counts a walk of K5's record and no replay."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    u0, eps, ys, params, span, nz, t_col, scfg = args
    group = fa.fused_adaptive_tile(u0.shape[0])
    t0, t1 = fa._times(u0, span)
    weights = fa.weights_of(params)
    before = _record_counts()
    _u1, rows, image, record = fa._launch_fwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg,
                                              group, max_nodes)
    assert tuple(record.nodes.shape) == (max_nodes, 6, nz, u0.shape[0])
    got = fa._launch_bwd(u0, eps, ys, weights, t0, t1, nz, t_col, scfg, max_nodes, gbar, group,
                         image, record)
    assert _record_counts() == (before[0] + 1, before[1])
    return rows, record, got


def _bits(out):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in (out[0], out[1], *out[2], out[3])]


@pytest.mark.parametrize("name", list(RECORD_CASES))
def test_k6_from_k5_record_gives_the_replay_bits(dev, name):
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    n_in, h, nz, nc, b = RECORD_CASES[name]
    args, gbar = _adaptive_case("flagship", dev, 5, h=h, b=b, resolved=True, nz=nz, nc=nc)
    assert args[3]["layers.0.weight"].shape[1] == n_in
    rows, record, got = _from_record(args, gbar)
    assert torch.equal(record.nacc, rows[:, 1].to(torch.int32)) and bool(record.done.all())
    assert all(torch.isfinite(t).all() for t in (got[0], got[1], *got[2]))
    before = _record_counts()
    want = fa.fused_solve_dopri5_bwd(*args, 64, gbar)
    assert _record_counts() == (before[0], before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(want)))


@pytest.mark.parametrize("what", ["past max_nodes", "not finished"])
def test_k6_poison_through_the_record(dev, what):
    """K6 on K5's record NaN-poisons exactly the rows of a group that
    accepted more steps than the record holds, or did not finish within
    max_steps, and every weight gradient; the other groups' rows stay
    finite.  d8's widths, 16 groups over draw scales of 0.1-10, so the
    groups take other step counts."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    args, gbar = _adaptive_case("flagship", dev, 5, h=72, b=2048, resolved=True, nz=17)
    rows = fa.fused_solve_dopri5(*args, 64)[1]
    max_nodes = 64
    if what == "past max_nodes":
        max_nodes = int(rows[:, 1].min())
        bad = rows[:, 1] > max_nodes
    else:
        steps = rows[:, 1] + rows[:, 2]
        args = args[:-1] + (args[-1][:6] + (int(steps.min()),),)
        bad = steps > steps.min()
    assert bool(bad.any()) and not bool(bad.all())
    _rows, record, got = _from_record(args, gbar, max_nodes)
    assert torch.equal(record.done == 0, bad) if what == "not finished" else bool(record.done.all())
    rows_bad = bad.repeat_interleave(128)
    for t in got[:2]:
        assert torch.isnan(t[rows_bad]).all() and torch.isfinite(t[~rows_bad]).all()
    assert all(torch.isnan(w).all() for w in got[2])


def test_fit_walks_k5_record_and_scoring_makes_none(dev, monkeypatch):
    """Under ICNFModel.fit at h = 72 (the d8 widths) every K6 launch walks
    K5's record and none replays the solve; a TRAIN loss under torch.no_grad
    launches K5 with no record, and no K6."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    icnf = cnf.ICNF.create(nvariables=8, naugments=9, fused=True, fused_adaptive=True)
    assert tuple(icnf.net.widths) == (18, 72, 72, 17)
    x = torch.randn((1024, 8), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    model = cnf.ICNFModel(icnf, batchsize=512, epochs=1, device=dev)
    before = _launches("K5", "K6") + list(_record_counts())
    res = model.fit(x)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_launches("K5", "K6") + list(_record_counts()), before)]
    assert moved == [2, 2, 2, 0], moved
    records = []
    monkeypatch.setattr(fa, "_launch_fwd", _keeping(fa._launch_fwd, records))
    before = _launches("K5", "K6")
    with torch.no_grad():
        loss = cnf.loss(icnf, Mode.TRAIN, x[:512], res.params,
                        torch.Generator(device=dev).manual_seed(2))
    assert torch.isfinite(loss)
    moved = [a - b for a, b in zip(_launches("K5", "K6"), before)]
    assert moved == [1, 0] and records == [None]


def _keeping(fn, kept):
    """``fn`` that keeps the last element of each result in ``kept``."""
    def call(*args):
        out = fn(*args)
        kept.append(out[-1])
        return out
    return call


# K6's replay at every H the plan can pick for K5 (h = 4 ... 32, h = 12 at 12),
# as its own kernel before the row walk; in the tiled walk's kernel (h = 33);
# the row replay inside the tiled walk's kernel, where 122 conditions make the
# walk too large for the row path (h = 27: H = 28, walk_H = 0); and the tiled
# replay before the row walk, where a 35-wide state makes K5's rows too large
# for its row path but not the walk's (h = 8: H = 0, walk_H = 8)
@pytest.mark.parametrize("h, nz, nc", [(4, 5, 0), (8, 5, 0), (12, 5, 0), (16, 5, 0), (20, 5, 0),
                                       (24, 5, 0), (28, 5, 0), (32, 5, 0), (33, 5, 0),
                                       (27, 5, 122), (8, 35, 0)])
def test_fused_adaptive_replay_takes_k5_steps(dev, h, nz, nc):
    from continuousnormalizingflows_tpu_torch.ops import _build
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    if nc or nz != 5:
        b = 256
        params = _params((nz + 1 + nc, h, h, nz), dev)
        g = torch.Generator(device=dev).manual_seed(5)
        u0 = torch.cat([0.5 * torch.randn((b, nz), generator=g, device=dev),
                        torch.zeros((b, 3), device=dev)], dim=-1)
        eps = torch.randn((b, nz), generator=g, device=dev)
        ys = torch.randn((b, nc), generator=g, device=dev) if nc else None
        args = (u0, eps, ys, params, (0.0, torch.tensor(1.05, device=dev)), nz, nz,
                ADAPTIVE_SCFG)
        gbar = torch.randn((b, nz + 3), generator=g, device=dev)
        plan = _build.adaptive_plan(nz + 1 + nc, h, nz, nz, nz + 3, 128)
        assert plan[::5] == ((28, 0) if nc else (0, 8))
    else:
        args, gbar = _adaptive_case("flagship", dev, h=h)
    rows = fa.fused_solve_dopri5(*args, 64)[1]
    nacc = fa.fused_solve_dopri5_bwd(*args, 64, gbar)[3]
    assert torch.equal(nacc, rows[:, 1].to(torch.int32))


@pytest.mark.parametrize("h", [24, 128])
def test_fused_adaptive_landing_that_rounds_past_t1(dev, h):
    """K5 and K6 (row path at h = 24, cluster path at h = 128) land on t1
    where t + (t1 - t) rounds past it in float32 (ctl_decide): zero weights
    make a constant field, one accepted step from dt0 = the whole span;
    past t1 the group would have stepped away from it to its step budget."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    t0, t1 = 0.2902631461620331, 0.905047  # t0 + (t1 - t0) > t1 in float32
    params = {k: torch.zeros_like(v) for k, v in _params((6, h, h, 5), dev).items()}
    u0, eps = torch.zeros((128, 8), device=dev), torch.ones((128, 5), device=dev)
    span = (torch.tensor(t0, device=dev), torch.tensor(t1, device=dev))
    args = (u0, eps, None, params, span, 5, 5, (1e-4, 1e-4, 1.0, 0.9, 0.2, 10.0, 8))
    u1, rows = fa.fused_solve_dopri5(*args, 64)
    assert torch.isfinite(u1).all() and int(rows[0, 1]) == 1 and int(rows[0, 2]) == 0
    got = fa.fused_solve_dopri5_bwd(*args, 64, torch.ones_like(u0))
    assert all(torch.isfinite(t).all() for t in (got[0], got[1], *got[2]))
    assert int(got[3][0]) == 1


@pytest.mark.parametrize("case", ["small", "two blocks"])
def test_fused_adaptive_poison_on_the_card(dev, case):
    """A node buffer too small NaN-poisons the backward (the forward stays
    finite): every row of the group and the sums of each of its walk blocks;
    a spent step budget NaN-poisons the forward."""
    from continuousnormalizingflows_tpu_torch.ops import fused_adaptive as fa

    args, gbar = _adaptive_case(case, dev)
    tight = args[:-1] + ((1e-6, 1e-6) + ADAPTIVE_SCFG[2:],)
    u1, rows = fa.fused_solve_dopri5(*tight, 2)
    assert torch.isfinite(u1).all() and int(rows[0, 1]) > 2
    got = fa.fused_solve_dopri5_bwd(*tight, 2, gbar)
    assert all(torch.isnan(t).all() for t in (got[0], got[1], *got[2]))
    spent = args[:-1] + (ADAPTIVE_SCFG[:6] + (2,),)
    u1, rows = fa.fused_solve_dopri5(*spent, 64)
    assert torch.isnan(u1).all() and rows[0, 0] == 13 and rows[0, 1] + rows[0, 2] == 2


def test_fused_adaptive_training_route(dev):
    """fused=True, fused_adaptive=True: a TRAIN loss is one K5 launch and its
    gradient one K6 launch; at rtol = atol = 1e-5 the discrete backward and
    the unfused continuous adjoint agree (same draws) to 1e-3 of the largest
    entry: both approximate the same sensitivity to O(tol) (the plain
    versions agree to 6e-6 on the CPU).  Data from the flagship's mixture:
    on N(0, 1) draws at 1e-6 some groups stall at float32 resolution and
    give up (NaN), in the plain version and the kernel alike."""
    from continuousnormalizingflows_tpu_torch.utils.datasets import gaussian_mixture

    solver = SolverConfig(rtol=1e-5, atol=1e-5)
    fused = cnf.ICNF.create(nvariables=2, solver=solver, fused=True, fused_adaptive=True)
    plain = cnf.ICNF.create(nvariables=2, solver=solver)
    params = {k: v.requires_grad_() for k, v in
              fused.init(torch.Generator().manual_seed(0), device=dev).items()}
    x = gaussian_mixture(torch.Generator(device=dev).manual_seed(1), 1024)
    grads = {}
    for name, icnf in (("fused", fused), ("plain", plain)):
        before = (_launches("K5"), _launches("K6"))
        loss = cnf.loss(icnf, Mode.TRAIN, x, params, torch.Generator(device=dev).manual_seed(2))
        grads[name] = torch.autograd.grad(loss, list(params.values()))
        moved = (_launches("K5") - before[0],
                 _launches("K6") - before[1])
        assert moved == ((1, 1) if name == "fused" else (0, 0))
    _close_to_max(grads["fused"], grads["plain"], 1e-3)


def test_default_stack_fused_stage_route(dev):
    """fused=True with the default SolverConfig (dopri5, backsolve adjoint):
    no whole-solve kernel applies, so the forward's evaluations launch K1 and
    the adjoint's VJPs K2, never K5/K6; the gradients equal the fused=False
    ones (same draws, the same steps) to 5e-4 of the largest entry, as the
    rk4 routes."""

    fused = cnf.ICNF.create(nvariables=2, fused=True)
    plain = cnf.ICNF.create(nvariables=2)
    params = {k: v.requires_grad_() for k, v in
              fused.init(torch.Generator().manual_seed(0), device=dev).items()}
    x = torch.randn((512, 2), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    kernels = ("K1", "K2", "K5", "K6")
    grads, steps = {}, {}
    for name, icnf in (("fused", fused), ("plain", plain)):
        before = _launches(*kernels)
        loss, st = cnf.loss_with_stats(icnf, Mode.TRAIN, x, params,
                                       torch.Generator(device=dev).manual_seed(2))
        grads[name] = torch.autograd.grad(loss, list(params.values()))
        moved = [a - b for a, b in zip(_launches(*kernels), before)]
        steps[name] = tuple(int(v) for v in st[:3])
        if name == "fused":
            assert moved[0] > 0 and moved[1] > 0 and moved[2:] == [0, 0]
        else:
            assert moved == [0, 0, 0, 0]
    assert steps["fused"] == steps["plain"]
    _close_to_max(grads["fused"], grads["plain"], 5e-4)


def test_abm_quadrature_fused_stage_route(dev):
    """fused=True with abm + quadrature (the reference's default stack):
    the forward's two evaluations a trial step launch K1 and the quadrature
    adjoint's VJPs K2, no other kernel; the fused step takes the unfused
    step's forward steps, and those of the same 256 points on the CPU, and
    its gradients equal the fused=False ones to 5e-4 of the largest entry."""

    solver = SolverConfig(method="abm", rtol=1e-4, atol=1e-4, gradient="quadrature")
    fused = cnf.ICNF.create(nvariables=2, solver=solver, fused=True)
    plain = cnf.ICNF.create(nvariables=2, solver=solver)
    params = fused.init(torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((256, 2), generator=torch.Generator().manual_seed(1)).to(dev)
    kernels = ("K1", "K2", "K3", "K4", "K5", "K6")
    grads, steps = {}, {}
    for name, icnf, where in (("fused", fused, dev), ("plain", plain, dev),
                              ("cpu", fused, torch.device("cpu"))):
        p = {k: v.detach().to(where).requires_grad_() for k, v in params.items()}
        before = _launches(*kernels)
        loss, st = cnf.loss_with_stats(icnf, Mode.TRAIN, x.to(where), p,
                                       torch.Generator().manual_seed(2))
        grads[name] = [g.to(dev) for g in torch.autograd.grad(loss, list(p.values()))]
        moved = [a - b for a, b in zip(_launches(*kernels), before)]
        steps[name] = tuple(int(v) for v in st[:3])
        if name == "fused":
            assert moved[0] > 0 and moved[1] > 0 and moved[2:] == [0, 0, 0, 0]
        else:
            assert moved == [0] * 6
    assert steps["fused"] == steps["plain"] == steps["cpu"]
    _close_to_max(grads["fused"], grads["plain"], 5e-4)
    _close_to_max(grads["fused"], grads["cpu"], 5e-4)


@pytest.mark.parametrize("solver,kw", [
    (SolverConfig(method="rk4", gradient="backprop", fixed_steps=8), {}),
    (SolverConfig(), {}),
    (SolverConfig(), {"fused_adaptive": True}),
], ids=["rk4", "default_stack", "fused_adaptive"])
def test_float64_fused_config_takes_the_unfused_route(dev, solver, kw):
    """A float64 config with ``fused=True`` does not raise on the card (the
    kernels take float32): every fused gate is closed, so its loss and
    gradients are float64, launch no kernel, and equal ``fused=False``'s
    bits, as on the CPU."""

    kernels = ("K1", "K2", "K3", "K4", "K5", "K6")
    x = torch.randn((256, 2), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    got = {}
    for fused in (True, False):
        icnf = cnf.ICNF.create(nvariables=2, dtype=torch.float64, fused=fused, solver=solver,
                               **kw)
        p = {k: v.requires_grad_() for k, v in
             icnf.init(torch.Generator().manual_seed(0), device=dev).items()}
        before = _launches(*kernels)
        loss = cnf.loss(icnf, Mode.TRAIN, x, p, torch.Generator(device=dev).manual_seed(2))
        grads = torch.autograd.grad(loss, list(p.values()))
        assert [a - b for a, b in zip(_launches(*kernels), before)] == [0] * 6
        assert loss.dtype == torch.float64 and all(g.dtype == torch.float64 for g in grads)
        got[fused] = (loss.detach(), grads)
    assert torch.equal(got[True][0], got[False][0]) and bool(torch.isfinite(got[True][0]))
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))


# ---- layout="feature_first": no kernel, the card's fit the CPU's ----

FEATURE_FIRST = {  # fused=True routes that a batch-first config takes through K3, K1, K5
    "rk4": (dict(method="rk4", gradient="backprop", fixed_steps=8), {}),
    "ffjord": (dict(method="rk4", gradient="backprop", fixed_steps=8),
               dict(lambda_1=0.0, lambda_2=0.0)),
    "dopri5": (dict(method="dopri5", rtol=1e-4, atol=1e-4), dict(fused_adaptive=True)),
}


def _all_launches():
    return tuple(_launches("K1", "K2", "K3", "K4", "K5", "K6"))


@pytest.mark.parametrize("route", list(FEATURE_FIRST))
def test_feature_first_fit_matches_the_cpu(dev, route):
    """``ICNFModel.fit`` of a feature-first config with ``fused=True``, 3
    steps on the card and on the CPU with the same draws (a CPU generator):
    no kernel launches (the unfused route, as in JAX), params within the
    solve tolerance rtol 5e-4 / atol 5e-5 and the losses too."""
    solver, kw = FEATURE_FIRST[route]
    icnf = cnf.ICNF.create(nvariables=2, solver=SolverConfig(**solver), fused=True,
                           layout="feature_first", **kw)
    x = 0.5 * torch.randn((384, 2), generator=torch.Generator().manual_seed(1))
    p0 = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    before = _all_launches()
    res = {}
    for d in ("cpu", dev):
        model = cnf.ICNFModel(icnf, batchsize=128, epochs=1, log_every=1, device=d,
                              generator=torch.Generator().manual_seed(5))
        res[torch.device(d).type] = model.fit(x, params={k: v.to(d) for k, v in p0.items()})
    assert _all_launches() == before
    cpu, card = res["cpu"], res["cuda"]
    assert card.stats["iterations"] == cpu.stats["iterations"] == 3
    torch.testing.assert_close(torch.tensor(card.history), torch.tensor(cpu.history),
                               rtol=5e-4, atol=5e-5)
    for k, v in cpu.params.items():
        torch.testing.assert_close(card.params[k].cpu(), v, rtol=5e-4, atol=5e-5)


def test_feature_first_entry_points_match_the_cpu(dev):
    """The default stack on a feature-first config on the card against the
    CPU (the draws on a CPU generator): ``inference`` (TEST), ``loss`` and
    its gradients (TRAIN), ``generate_with_logp``, ``ICNFDist.logpdf``,
    ``trajectory`` and the exported TEST log-density, each with the CPU's
    steps, values within 5e-4 / 5e-5 (gradients 5e-4 of each tensor's
    largest), and no kernel launched."""
    from continuousnormalizingflows_tpu_torch.utils import export as ex

    icnf = cnf.ICNF.create(nvariables=2, layout="feature_first", fused=True)
    x = 0.5 * torch.randn((512, 2), generator=torch.Generator().manual_seed(1))
    p0 = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    ts = torch.linspace(0.0, 1.0, 4)
    before = _all_launches()
    res = {}
    for d in ("cpu", dev):
        p = {k: v.to(d).requires_grad_() for k, v in p0.items()}
        xd = x.to(d)
        loss, st = cnf.loss_with_stats(icnf, Mode.TRAIN, xd, p, torch.Generator().manual_seed(3))
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            lp, _a, st_test = cnf.inference(icnf, Mode.TEST, xd, p)
            s, lps = cnf.generate_with_logp(icnf, Mode.TEST, p, torch.Generator().manual_seed(4),
                                            256)
            dens = cnf.ICNFDist(icnf, p).logpdf(xd)
            path, _st = cnf.trajectory(icnf, xd[:64], p, ts.to(d))
        served, nfe, _na, _nr = ex._export_logpdf(icnf, p, device=d).call(xd)
        counts = [int(v) for c in (st, st_test) for v in (c.nfe, c.naccept, c.nreject)]
        res[torch.device(d).type] = (counts + [int(nfe)], [loss.detach(), lp, s, lps, dens, path,
                                                          served], grads)
    assert _all_launches() == before
    (cc, vc, gc), (cd, vd, gd) = res["cpu"], res["cuda"]
    assert cd == cc
    for a, b in zip(vd, vc):
        torch.testing.assert_close(a.cpu(), b, rtol=5e-4, atol=5e-5)
    _close_to_max([g.cpu() for g in gd], list(gc), 5e-4)
