"""Fault tolerance: restartable training driver, step watchdog, straggler
detection, failure injection (port of ``repro.runtime.fault``).

On a 1000+-node fleet the failure model is: a worker dies (preemption,
ECC, network) -> the job controller restarts the step loop from the last
complete checkpoint, possibly on a *different* mesh (elastic). This module
implements that control plane:

* ``TrainDriver.run`` — the step loop: data -> step -> metrics ->
  periodic async checkpoint. Any exception triggers restore-from-latest
  and continuation; the data pipeline is step-indexed so the replayed
  batches are identical (determinism is unit-tested).
* ``Watchdog`` — per-step wall-time EWMA; a step slower than
  ``threshold x`` EWMA flags a straggler (on a real fleet this triggers
  hot-spare swap / job re-scheduling; here it is recorded and tested with
  injected delays).
* ``FailureInjector`` — deterministic fault injection for tests/examples.

Where the reference waits with ``jax.block_until_ready``, the port
synchronizes the device of the metrics. The restore target is a device,
or target shardings (a spec tree and a mesh) as in the reference; in a
process group every rank finds the same latest checkpoint
(``CheckpointManager.latest`` holds the ranks at a barrier).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager


class Watchdog:
    """EWMA step-time monitor with straggler flagging."""

    def __init__(self, *, alpha: float = 0.2, threshold: float = 3.0,
                 warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.stragglers: List[Dict[str, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        outlier = dt > self.threshold * self.ewma
        flagged = outlier and self.n > self.warmup
        if flagged:
            self.stragglers.append({"step": step, "dt": dt,
                                    "ewma": self.ewma})
        if not outlier:
            # outliers are excluded from the EWMA so one hiccup does not
            # raise the bar for detecting the next one — INCLUDING during
            # warmup: an early hiccup is silenced (no flag) but must not
            # poison the baseline every later step is judged against
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged


class FailureInjector:
    """Raises a simulated preemption at the given global steps (once each)."""

    def __init__(self, fail_at: List[int]):
        self.fail_at = set(fail_at)
        self.failed: set = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.failed:
            self.failed.add(step)
            raise RuntimeError(f"injected preemption at step {step}")


@dataclasses.dataclass
class DriverReport:
    steps_run: int
    restarts: int
    final_step: int
    metrics_history: List[Dict[str, float]]
    stragglers: List[Dict[str, float]]


class TrainDriver:
    """Restartable step loop.

    Args:
      step_fn: (state, batch) -> (state, metrics), ``runtime.steps``'.
      init_state_fn: () -> fresh TrainState (used when no checkpoint).
      batch_at: step -> host batch (deterministic, shard-aware).
      ckpt: CheckpointManager (or None to disable).
      template_fn: () -> a TrainState template to restore into (meta tensors
        will do: ``steps.abstract_train_state``); default ``init_state_fn``.
      device: where a restored state goes; default the template's.
      state_shardings, mesh: on a mesh, the restored state's spec tree
        (``steps.train_state_shardings``) and the mesh it is placed on.
    """

    def __init__(self, step_fn: Callable, init_state_fn: Callable,
                 batch_at: Callable[[int], Dict[str, np.ndarray]],
                 ckpt: Optional[CheckpointManager] = None,
                 template_fn: Optional[Callable] = None,
                 device: Any = None,
                 watchdog: Optional[Watchdog] = None,
                 failure_injector: Optional[FailureInjector] = None,
                 max_restarts: int = 3,
                 state_shardings: Any = None, mesh: Any = None):
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.batch_at = batch_at
        self.ckpt = ckpt
        self.template_fn = template_fn or init_state_fn
        self.device = device
        self.watchdog = watchdog or Watchdog()
        self.injector = failure_injector
        self.max_restarts = max_restarts
        self.state_shardings = state_shardings
        self.mesh = mesh

    def _restore_or_init(self):
        if self.ckpt is not None and self.ckpt.latest() is not None:
            state = self.ckpt.restore_latest(
                self.template_fn(), self.device,
                shardings=self.state_shardings, mesh=self.mesh)
            start = int(state.step)
            return state, start
        return self.init_state_fn(), 0

    def run(self, n_steps: int, *, log_every: int = 10,
            log: Callable[[str], None] = print) -> DriverReport:
        restarts = 0
        history: List[Dict[str, float]] = []
        steps_run = 0
        while True:
            try:
                state, start = self._restore_or_init()
                if restarts and start:
                    log(f"[driver] restart #{restarts}: resumed from "
                        f"checkpoint step {start}")
                for step in range(start, n_steps):
                    if self.injector is not None:
                        self.injector.check(step)
                    batch = self.batch_at(step)
                    t0 = time.perf_counter()
                    state, metrics = self.step_fn(state, batch)
                    _synchronize(metrics)
                    dt = time.perf_counter() - t0
                    flagged = self.watchdog.observe(step, dt)
                    if flagged:
                        log(f"[watchdog] straggler at step {step}: "
                            f"{dt * 1e3:.1f} ms vs EWMA "
                            f"{self.watchdog.ewma * 1e3:.1f} ms")
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["dt"] = dt
                    history.append(m)
                    steps_run += 1
                    if step % log_every == 0:
                        log(f"[train] step {step} "
                            f"loss={m.get('loss', float('nan')):.4f} "
                            f"({dt * 1e3:.0f} ms)")
                    if self.ckpt is not None:
                        # checkpoint the *post-step* state (step counter
                        # already advanced -> resume replays nothing)
                        self.ckpt.maybe_save(step + 1, state)
                if self.ckpt is not None:
                    self.ckpt.maybe_save(n_steps, state, force=True)
                    self.ckpt.wait()
                return DriverReport(
                    steps_run=steps_run, restarts=restarts,
                    final_step=n_steps, metrics_history=history,
                    stragglers=self.watchdog.stragglers)
            except Exception as e:                    # noqa: BLE001
                restarts += 1
                state = None         # free it before the restore
                log(f"[driver] failure: {e!r}")
                if restarts > self.max_restarts or self.ckpt is None:
                    raise
                try:     # drain any in-flight async write before restoring
                    self.ckpt.wait()
                except Exception:                     # noqa: BLE001
                    pass
                # fall through: restore from latest checkpoint and continue


def _synchronize(metrics: Dict[str, Any]) -> None:
    """Wait for the device that holds the metrics (the reference's
    ``jax.block_until_ready``)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return
