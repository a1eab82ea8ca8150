"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  The machine with the
card has no JAX, so run this file there without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: one fp32 stage rtol 1e-4 / atol 1e-5 (same products, another
summation order); a 32-step fp32 solve rtol 5e-4 / atol 5e-5 (128 stages of
that).  bf16 operands: an fp32 sum in another order can move a later bf16
rounding by one place (2^-8 relative), so rtol/atol 2e-2 for a stage and 5e-2
for a solve.
"""

import pytest
import torch

from continuousnormalizingflows_tpu_torch.models.nets import MLP
from continuousnormalizingflows_tpu_torch.ops.fused_dynamics import (
    fused_dynamics_vjp,
    mlp3_forward_vjp_reference,
)
from continuousnormalizingflows_tpu_torch.ops.fused_solve import (
    fused_solve_rk4,
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


def test_kernels_refuse_gradients(dev):
    params = {k: v.requires_grad_() for k, v in _params((6, 24, 24, 5), dev).items()}
    x = torch.randn((8, 6), device=dev)
    eps = torch.randn((8, 5), device=dev)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_dynamics_vjp(x, eps, params, 5)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_solve_rk4(torch.zeros((8, 8), device=dev), eps, None, params, (0.0, 1.0), 5, 5, 4)
    with torch.no_grad():
        fused_dynamics_vjp(x, eps, params, 5)  # no graph recorded: allowed
