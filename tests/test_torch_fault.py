"""The port's fault-tolerant driver (``repro_torch.runtime.fault``) and
``launch.train`` on the CPU: the cases of tests/test_fault.py, a restart
from a checkpoint that is bit-deterministic (the resumed trajectory and the
final state equal an uninterrupted run exactly), and the training CLI run
end to end with an injected preemption.
"""

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as train_cli
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.fault import (DriverReport, FailureInjector,
                                       TrainDriver, Watchdog)


def test_watchdog_flags_stragglers():
    w = Watchdog(alpha=0.5, threshold=2.0, warmup=1)
    flags = [w.observe(i, dt) for i, dt in
             enumerate([0.1, 0.1, 0.1, 0.5, 0.1])]
    assert flags == [False, False, False, True, False]
    assert len(w.stragglers) == 1 and w.stragglers[0]["step"] == 3
    assert w.ewma == pytest.approx(0.1, rel=0.05)


def test_watchdog_warmup_outlier_does_not_poison_ewma():
    w = Watchdog(alpha=0.5, threshold=3.0, warmup=3)
    flags = [w.observe(i, dt) for i, dt in
             enumerate([0.1, 1.0, 0.1, 0.1, 0.5])]
    assert flags == [False, False, False, False, True]
    assert len(w.stragglers) == 1 and w.stragglers[0]["step"] == 4
    assert w.ewma == pytest.approx(0.1, rel=0.05)


def test_injector_fires_once():
    inj = FailureInjector([3])
    inj.check(2)
    with pytest.raises(RuntimeError):
        inj.check(3)
    inj.check(3)   # second time: no raise


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_smoke("glm4-9b")
    shape = InputShape("train_4k", 16, 4, "train")
    train = steps_mod.TrainSpec(peak_lr=1e-3, warmup_steps=2,
                                total_steps=50)
    step = steps_mod.build_train_step(cfg, train, shape, "cpu")
    data = SyntheticLMData(cfg, shape, seed=11)
    init = lambda: steps_mod.init_train_state(cfg, 1, train, "cpu")
    return step, init, data, cfg, train


def test_restart_is_bit_deterministic(setup, tmp_path):
    step, init, data, cfg, train = setup
    ckpt = CheckpointManager(str(tmp_path), period=3, keep=3)
    drv = TrainDriver(step_fn=step, init_state_fn=init,
                      batch_at=data.batch_at, ckpt=ckpt,
                      template_fn=lambda: steps_mod.abstract_train_state(
                          cfg, train),
                      device="cpu", failure_injector=FailureInjector([5]))
    logs = []
    rep: DriverReport = drv.run(8, log_every=1000, log=logs.append)
    assert rep.restarts == 1 and rep.final_step == 8
    assert any("resumed from checkpoint step 3" in line for line in logs)
    assert [m["step"] for m in rep.metrics_history] == [0, 1, 2, 3, 4,
                                                        3, 4, 5, 6, 7]

    state = init()                      # the uninterrupted run
    losses = []
    for i in range(8):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    resumed = [m["loss"] for m in rep.metrics_history]
    assert resumed[:5] + resumed[7:] == losses   # bit-equal, replays too
    assert resumed[5:7] == losses[3:5]
    restored = ckpt.restore_latest(steps_mod.abstract_train_state(cfg, train),
                                   device="cpu")
    assert latest_step(str(tmp_path)) == 8
    for got, want in zip(tree.leaves(restored), tree.leaves(state)):
        assert torch.equal(got.detach(), want.detach())


def test_driver_without_checkpoints_runs_from_scratch(setup):
    step, init, data, *_ = setup
    rep = TrainDriver(step_fn=step, init_state_fn=init,
                      batch_at=data.batch_at).run(2, log=lambda s: None)
    assert rep.steps_run == 2 and rep.restarts == 0
    assert all(np.isfinite(m["loss"]) for m in rep.metrics_history)
    with pytest.raises(RuntimeError, match="injected"):
        TrainDriver(step_fn=step, init_state_fn=init, batch_at=data.batch_at,
                    failure_injector=FailureInjector([1])).run(
                        2, log=lambda s: None)


def test_driver_raises_after_max_restarts(setup, tmp_path):
    step, init, data, *_ = setup
    ckpt = CheckpointManager(str(tmp_path), period=100, keep=1)
    drv = TrainDriver(step_fn=step, init_state_fn=init,
                      batch_at=data.batch_at, ckpt=ckpt,
                      failure_injector=FailureInjector([0, 1, 2]),
                      max_restarts=2)
    with pytest.raises(RuntimeError):
        drv.run(4, log_every=1000, log=lambda s: None)


def test_train_cli_runs_with_an_injected_failure(tmp_path, capsys):
    rep = train_cli.main(["--arch", "internvl2-1b", "--smoke", "--device",
                          "cpu", "--steps", "4", "--batch", "2", "--seq",
                          "8", "--warmup", "2", "--ckpt-dir",
                          str(tmp_path), "--ckpt-period", "2",
                          "--inject-failure-at", "3"])
    out = capsys.readouterr().out
    assert rep.restarts == 1 and rep.final_step == 4
    assert rep.steps_run == 5                  # steps 0-3, then 2-3 again
    assert "resumed from checkpoint step 2" in out
    assert "attn=kernel block=fused" in out
    assert latest_step(str(tmp_path)) == 4
    assert all(np.isfinite(m["loss"]) for m in rep.metrics_history)


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "glm4-9b", "--smoke", "--steps", "1"])
