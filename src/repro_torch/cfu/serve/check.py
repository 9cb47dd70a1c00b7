"""Differential spot checks: the serving numbers stay anchored to the
golden model.

A queueing simulation is only as honest as its service model. The
dispatcher therefore periodically takes a *sampled dispatched batch* and
actually executes it: fresh random frames, quantized, driven through the
compiled words by the golden executor (``run_program`` for one core,
``MultiStreamRunner`` for the pipeline) or the fast path, and compared
bit-exactly against ``models.mobilenetv2.forward_batch``. On top of
bit-exactness it
asserts the scheduler's FRAME ACCOUNTING matches the executor's:

* the executor retires exactly the dispatched ``B`` frames (no ragged
  padding leaking into the count),
* the runner needed exactly the round structure the cost model priced —
  ``ceil(B / B) = 1`` group per core, i.e. ``n_cores`` steps total, the
  same rounds ``timing.MultiStreamReport.cycles_for_frames(B)`` charges
  (one entry round + ``N - 1`` drain rounds).

A failure raises :class:`SpotCheckError` — the simulation aborts rather
than report throughput numbers the hardware model would not honour.

The device
----------
This is the one module of the simulator that touches the card. The
golden executor reads host arrays only, so the checker holds the CFU
parameters on the host (``vww_cfu_params`` of a CPU network), shared by
``run_program``, ``MultiStreamRunner`` and ``fastpath.run_fast``, which
moves them to its device on every call. The fast path runs on
``device`` (``for_vww``: the network's device, and no other) and returns
an int8 tensor there; the sampler's reference inference runs the plain
v3 ``forward_batch`` on the network's device, as the reference does, so
on a card every fast check holds the DSC kernel to an independent
output on the same device. Outputs are compared
explicitly: ``torch.equal`` for two tensors on one device, else each side
brought to the host (``.cpu().numpy()``) and compared by numpy. A kernel
error is never caught: it aborts the check, and the simulation with it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cfu.compiler import MultiStreamProgram
from repro_torch.cfu.executor import MultiStreamRunner, run_program


class SpotCheckError(AssertionError):
    """A sampled dispatched batch diverged from the golden executor."""


@dataclasses.dataclass
class SpotCheckRecord:
    batch_id: int
    size: int
    bit_exact: bool
    groups_executed: int
    groups_modeled: int
    backend: str = "golden"          # executor that produced the check
    golden_cross: bool = False       # fast check also re-run on the golden


# sample(rng, n) -> (quantized input frames (n,H,W,C) int8 on the host,
#                    expected quantized outputs per frame: an array, or
#                    a tensor on the reference network's device)
Output = Union[np.ndarray, torch.Tensor]
SampleFn = Callable[[np.random.Generator, int], Tuple[np.ndarray, Output]]


def _host(y: Output) -> np.ndarray:
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def outputs_equal(a: Output, b: Output) -> bool:
    """Bit-equality of two int8 outputs: ``torch.equal`` for two tensors
    on one device, else both brought to the host explicitly."""
    if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.device == b.device):
        return torch.equal(a, b)
    return bool(np.array_equal(_host(a), _host(b)))


def vww_sampler(net, img_hw: int, img_ch: int = 3) -> SampleFn:
    """Sampler for a ``compile_vww_network`` program: random float
    images, quantized on the host for the executor, referenced through
    the SAME quantized network's int8 inference (the plain schedule) on
    the network's device."""
    from repro_torch.core import quant
    from repro_torch.models import mobilenetv2 as mnv2

    def sample(rng, n):
        imgs = rng.standard_normal(
            (n, img_hw, img_hw, img_ch)).astype(np.float32)
        frames_q = quant.quantize(imgs, net.qp_img).numpy()
        ref = mnv2.forward_batch(imgs, net, return_quantized=True)
        return frames_q, ref

    return sample


class DifferentialSpotCheck:
    """Executes sampled dispatched batches bit-exactly.

    ``every`` sets the sampling cadence (every k-th dispatched batch is
    executed) and ``max_checks`` bounds the total executor work; both
    keep the discrete-event loop fast while still pinning it to the
    golden model.

    ``backend`` picks the executor that runs each sampled batch:

    * ``"golden"`` (default) — the word interpreter, with the full frame
      accounting assertions; the historical behaviour.
    * ``"fast"`` — the fast path (``cfu/fastpath.py``) on ``device``
      (``cuda`` unless the caller asks for the CPU; ``for_vww`` takes the
      network's device). Checks cost milliseconds instead of a second,
      so million-request capacity planning can afford a much higher
      ``max_checks``; every
      ``golden_every``-th fast check ALSO re-runs the same frames through
      the word interpreter and asserts fast == golden bit-exactly, so
      the chain back to the golden model is sampled, never severed.
    """

    def __init__(self, prog, params, sample: SampleFn,
                 every: int = 8, max_checks: int = 3, seed: int = 0,
                 backend: str = "golden", golden_every: int = 4,
                 device="cuda"):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if backend not in ("golden", "fast"):
            raise ValueError(f"backend must be 'golden' or 'fast', "
                             f"got {backend!r}")
        if golden_every < 1:
            raise ValueError(f"golden_every must be >= 1, "
                             f"got {golden_every}")
        self.prog = prog
        self.params = params
        self.sample = sample
        self.every = every
        self.max_checks = max_checks
        self.backend = backend
        self.golden_every = golden_every
        # the fast path's device, resolved up front: no card, no run
        self.device = resolve_device(device) if backend == "fast" else None
        self.rng = np.random.default_rng(seed)
        self.records: List[SpotCheckRecord] = []
        self._dispatches = 0
        self._fast_checks = 0

    @classmethod
    def for_vww(cls, prog, net, params, img_hw: int, img_ch: int = 3,
                **kw) -> "DifferentialSpotCheck":
        """``net`` is the port's network on the device the checks run on;
        ``params`` the host CFU records (``vww_cfu_params`` of a CPU
        copy of it). The network's device is the checks' only device,
        so a ``device`` argument is refused (``TypeError``)."""
        return cls(prog, params, vww_sampler(net, img_hw, img_ch),
                   device=net.device, **kw)

    # --- sampling ---------------------------------------------------------

    def wants(self, batch_id: int) -> bool:
        """Deterministic cadence: every k-th dispatch, bounded total."""
        self._dispatches += 1
        return (len(self.records) < self.max_checks
                and (self._dispatches - 1) % self.every == 0)

    # --- the check itself -------------------------------------------------

    def _run_golden(self, batch_id: int, frames_q) -> Tuple[np.ndarray,
                                                            int]:
        """Word-interpreter execution + the frame-accounting assertions."""
        size = frames_q.shape[0]
        if isinstance(self.prog, MultiStreamProgram):
            runner = MultiStreamRunner(self.prog, frames_q, self.params,
                                       batch=size).run()
            y = runner.outputs()
            groups_executed = runner.n_groups
            steps = int(sum(runner.next_group))
            if steps != runner.n_groups * runner.n_cores:
                raise SpotCheckError(
                    f"batch {batch_id}: executor ran {steps} core-steps, "
                    f"accounting wants "
                    f"{runner.n_groups * runner.n_cores}")
        else:
            y = run_program(self.prog, frames_q, self.params)
            groups_executed = 1
        return y, groups_executed

    def check(self, batch_id: int, size: int) -> SpotCheckRecord:
        frames_q, ref = self.sample(self.rng, size)
        groups_modeled = -(-size // size)          # ceil(B / batch=B) = 1
        golden_cross = False
        if self.backend == "fast":
            from repro_torch.cfu import fastpath
            y = fastpath.run_fast(self.prog, frames_q, self.params,
                                  device=self.device)
            golden_cross = self._fast_checks % self.golden_every == 0
            self._fast_checks += 1
            if golden_cross:
                y_gold, groups_executed = self._run_golden(batch_id,
                                                           frames_q)
                if not outputs_equal(y, y_gold):
                    raise SpotCheckError(
                        f"batch {batch_id} (size {size}): fast path "
                        f"diverged from the golden interpreter")
            else:
                groups_executed = groups_modeled
        else:
            y, groups_executed = self._run_golden(batch_id, frames_q)
        if y.shape[0] != size:
            raise SpotCheckError(
                f"batch {batch_id}: executor retired {y.shape[0]} frames "
                f"for a dispatched group of {size}")
        if groups_executed != groups_modeled:
            raise SpotCheckError(
                f"batch {batch_id}: executor needed {groups_executed} "
                f"groups, the cost model priced {groups_modeled}")
        bit_exact = outputs_equal(y, ref)
        rec = SpotCheckRecord(batch_id=batch_id, size=size,
                              bit_exact=bit_exact,
                              groups_executed=groups_executed,
                              groups_modeled=groups_modeled,
                              backend=self.backend,
                              golden_cross=golden_cross)
        self.records.append(rec)
        if not bit_exact:
            raise SpotCheckError(
                f"batch {batch_id} (size {size}): executor output is NOT "
                f"bit-exact vs the int8 reference inference")
        return rec

    def summary(self) -> dict:
        return {"n_checks": len(self.records),
                "all_bit_exact": all(r.bit_exact for r in self.records),
                "checked_sizes": [r.size for r in self.records],
                "backend": self.backend,
                "n_golden_cross": sum(r.golden_cross
                                      for r in self.records)}
