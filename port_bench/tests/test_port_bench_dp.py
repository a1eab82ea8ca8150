"""The four-chip cell's run on 4 gloo ranks on the CPU at a tiny size: a
sound run is correct, and one whose gradient exchange is left out is not."""

import pytest

from port_bench import harness

from conftest import tiny_ctx

NAME = "d43-fit-rk4-fused-dp4"


def no_exchange():
    """Plant the fault: the gradient bucket's all-reduce left out."""
    from continuousnormalizingflows_tpu_torch.parallel import mesh

    real = mesh._all_reduce

    def skip(t, group, op=mesh.dist.ReduceOp.SUM, site="all_reduce"):
        return t if site == "grad" else real(t, group, op, site)

    mesh._all_reduce = skip


def faulty_rank_main(ctx, port):
    no_exchange()
    harness.set_precision()
    harness._init_rank(ctx, port)
    try:
        harness.run_rank(ctx)
    finally:
        harness.torch.distributed.destroy_process_group()


@pytest.mark.parametrize("fault", [False, True])
def test_four_ranks(monkeypatch, fault):
    ctx, metrics = tiny_ctx(NAME, seconds=0.3)
    assert ctx.world == 4
    if fault:
        from continuousnormalizingflows_tpu_torch.parallel import mesh

        real = mesh._all_reduce
        no_exchange()
        monkeypatch.setattr(mesh, "_all_reduce", mesh._all_reduce)
        monkeypatch.setattr(harness, "rank_main", faulty_rank_main)
        try:
            out = harness.result(ctx, harness.run_cell(ctx), metrics)
        finally:
            mesh._all_reduce = real
        assert not out["correct"], out["checks"]
    else:
        out = harness.result(ctx, harness.run_cell(ctx), metrics)
        assert out["correct"], out["checks"]
        assert out["device"]["count"] == 4 and set(out["metrics"]) == {
            "train_samples_per_s", "setup_s"}
