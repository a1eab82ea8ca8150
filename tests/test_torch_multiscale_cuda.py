"""FFJORD's multiscale flow on the card: the fixed-step backsolve's solves
captured as CUDA graphs and replayed against the same solves run eagerly.

Marked ``cuda``: each test skips without a CUDA device.  The machine with the
card has no JAX, so run this file there without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_multiscale_cuda.py -q

Tolerance: the replays run the kernels the eager solves run, on the same
values, but cuDNN's weight gradients may sum in another order from call to
call, so losses are held to rtol 1e-6, gradients to 1e-5 of their norm, and
parameters after four Adam steps to 1e-4 of a step (``lr``): the sums' order
moved them by 1.5e-5 of a step on the card."""

import pytest
import torch

import continuousnormalizingflows_tpu_torch as cnf
from continuousnormalizingflows_tpu_torch.config import Mode, SolverConfig
from continuousnormalizingflows_tpu_torch.ops import adjoint

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fit(dev, shape=(3, 16, 16), b=8):
    chain = cnf.MultiscaleICNF.create(
        shape=shape, hidden=(16, 16, 16),
        solver=SolverConfig(method="rk4", fixed_steps=2, gradient="adjoint"))
    x = torch.randint(0, 256, (2 * b, shape[0] * shape[1] * shape[2]), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(9)).float()
    model = cnf.ICNFModel(chain, optimizer=cnf.default_optimizer(1e-3, 0.0), batchsize=b,
                          epochs=2, log_every=1, batch_transform=cnf.dequantize, device=dev)
    params = chain.init(torch.Generator(device=dev).manual_seed(3), dev)
    return chain, model.fit(x, params=params, generator=torch.Generator(device=dev).manual_seed(5))


def test_replayed_solves_match_the_eager_ones(dev, monkeypatch):
    chain, replayed = _fit(dev)
    n_blocks = len(chain.blocks)
    assert sum(len(b.graphs.get(Mode.TRAIN, {})) for b in chain.blocks) == 2 * n_blocks
    monkeypatch.setattr(adjoint, "_capturable", lambda cfg, x: False)
    eager_chain, eager = _fit(dev)
    assert all(not g for g in eager_chain.blocks[0].graphs.values())
    assert replayed.history == pytest.approx(eager.history, rel=1e-6)
    for k, v in eager.params.items():
        assert float((replayed.params[k] - v).abs().max()) <= 1e-4 * 1e-3, k


def test_a_replayed_step_reads_new_weights(dev, monkeypatch):
    """A later call with other weights (a new fit's copies) replays on them."""
    chain, res = _fit(dev)
    x = cnf.dequantize(torch.Generator(device=dev).manual_seed(1),
                       torch.randint(0, 256, (8, 768), device=dev).float())
    params = {k: v.clone().requires_grad_() for k, v in res.params.items()}

    def loss_and_grads():
        g = torch.Generator(device=dev).manual_seed(2)
        loss = chain.loss_with_stats(Mode.TRAIN, x, params, g)[0]
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    loss, grads = loss_and_grads()
    monkeypatch.setattr(adjoint, "_capturable", lambda cfg, x: False)
    want, want_g = loss_and_grads()
    assert loss == pytest.approx(want, rel=1e-6)
    for a, b in zip(grads, want_g):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm())
