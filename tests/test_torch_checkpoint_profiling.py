"""The port's ``AsyncCheckpointer``, ``profiling.trace`` and ``StepTimer``.

Checkpoints are compared exactly (a copy is the same bits); every join and
wait in these tests ends in under a second on the CPU.
"""

import glob
import json
import os
import threading

import pytest
import torch

import continuousnormalizingflows_tpu_torch as tcnf
from continuousnormalizingflows_tpu_torch.utils import (AsyncCheckpointer, load_checkpoint,
                                                        profiling)
from continuousnormalizingflows_tpu_torch.utils import checkpoint as ckpt_mod


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"layers.0.weight": torch.randn(4, 3, generator=g),
              "layers.0.bias": torch.randn(4, generator=g)}
    opt = torch.optim.Adam(list(params.values()))
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    return params, opt


def test_async_save_round_trips(tmp_path):
    params, opt = _state()
    with AsyncCheckpointer() as ck:
        ck.save(str(tmp_path / "c"), params, opt.state_dict(), step=7)
    got, opt_state, step = load_checkpoint(str(tmp_path / "c"))
    assert step == 7 and set(got) == set(params)
    for k in params:
        torch.testing.assert_close(got[k], params[k], rtol=0, atol=0)
    fresh = torch.optim.Adam([torch.zeros_like(p) for p in params.values()])
    fresh.load_state_dict(opt_state)  # a usable optimizer state
    assert int(fresh.state_dict()["state"][0]["step"]) == 1


def test_save_copies_before_it_returns(tmp_path, monkeypatch):
    """In-place changes after ``save()`` (what ``opt.step()`` does) do not
    reach the file, even while the worker has not written yet."""
    params, opt = _state()
    before = {k: v.clone() for k, v in params.items()}
    release = threading.Event()
    write = ckpt_mod.save_checkpoint

    def slow_write(*a, **k):
        release.wait(timeout=10)
        write(*a, **k)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow_write)
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "c"), params, opt.state_dict(), step=1)
    with torch.no_grad():
        for p in params.values():
            p.add_(1.0)
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    release.set()
    ck.wait()
    got, _opt, _step = load_checkpoint(str(tmp_path / "c"))
    for k in before:
        torch.testing.assert_close(got[k], before[k], rtol=0, atol=0)


def test_two_saves_leave_the_second(tmp_path):
    ck = AsyncCheckpointer()
    path = str(tmp_path / "c")
    ck.save(path, _state(0)[0], step=1)
    second = _state(1)[0]
    ck.save(path, second, step=2)
    ck.wait()
    got, opt_state, step = load_checkpoint(path)
    assert step == 2 and opt_state is None
    for k in second:
        torch.testing.assert_close(got[k], second[k], rtol=0, atol=0)


def test_worker_error_surfaces_at_wait(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", broken)
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "c"), _state()[0])
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once; the checkpointer is usable again
    monkeypatch.undo()
    ck.save(str(tmp_path / "d"), _state()[0], step=3)
    ck.wait()
    assert load_checkpoint(str(tmp_path / "d"))[2] == 3


def test_worker_error_surfaces_at_next_save(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "save_checkpoint",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("no space")))
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "c"), _state()[0])
    with pytest.raises(OSError, match="no space"):
        ck.save(str(tmp_path / "c"), _state()[0])


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    with AsyncCheckpointer() as ck:
        ck.save(str(tmp_path / "c"), _state()[0], step=1)
    assert not (tmp_path / "c").exists()
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    with AsyncCheckpointer() as ck:
        ck.save(str(tmp_path / "c"), _state()[0], step=1)
    assert load_checkpoint(str(tmp_path / "c"))[2] == 1


def test_model_load_reads_an_async_checkpoint(tmp_path):
    icnf = tcnf.ICNF.create(nvariables=2)
    params = icnf.init(torch.Generator().manual_seed(0), device="cpu")
    with AsyncCheckpointer() as ck:
        ck.save(str(tmp_path / "c"), params, step=5)
    got = tcnf.ICNFModel(icnf, device="cpu").load(str(tmp_path / "c"))
    for k in params:
        torch.testing.assert_close(got[k], params[k], rtol=0, atol=0)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    files = glob.glob(os.path.join(str(tmp_path / "tr"), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_step_timer_counts_after_the_first_tick():
    timer = profiling.StepTimer(batch=32)
    assert timer.steps == 0 and timer.seconds_per_step != timer.seconds_per_step  # nan
    outs = [torch.ones(2), (torch.ones(1), [torch.zeros(1)]), {"a": torch.ones(1)}, None]
    for out in outs:
        timer.tick(out)
    assert timer.steps == len(outs) - 1
    assert timer.seconds_per_step > 0
    assert timer.samples_per_sec == pytest.approx(32 / timer.seconds_per_step, rel=0.5)
