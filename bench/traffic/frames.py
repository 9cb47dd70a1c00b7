"""Traffic kind ``frames``: one client classifying batches of frames in a
closed loop, each batch sent when the last one's logits are on the host.

Mix parameters: ``batch`` (frames a request), ``pool`` (distinct batches,
drawn from the seed and sent in turn), ``resident`` (the pool lives on the
device, as a loaded photo set would; otherwise each request starts from
host float32 frames, as a camera's would), ``trace_seconds`` (the traced
window's length at most). A request ends when its int8 logits are on the
host. The check compares every request's logits with the reference's for
its batch: exactly, the configuration being integer arithmetic.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from bench.harness import Check, Record


class Data:
    def __init__(self, frames: np.ndarray, batches: List[torch.Tensor]):
        self.frames = frames             # (pool, batch, H, W, C) float32
        self.batches = batches           # what each request sends


def inputs(mix: dict, cfg: dict, seed: int, device) -> Data:
    rng = np.random.default_rng([seed, 1])
    hw, ch = cfg["img_hw"], cfg["img_ch"]
    frames = rng.standard_normal(
        (mix["pool"], mix["batch"], hw, hw, ch)).astype(np.float32)
    batches = [torch.from_numpy(f) for f in frames]
    if mix["resident"]:
        batches = [b.to(device) for b in batches]
    return Data(frames, batches)


def warm(system, data: Data, mix: dict) -> None:
    for b in data.batches[:2]:
        system.classify(b).cpu()


def window(system, data: Data, mix: dict, seconds: float) -> Record:
    lat, sent, outs = [], [], []
    items, n = 0, 0
    clock = time.perf_counter
    end = clock() + seconds
    while True:
        t = clock()
        if t >= end:
            break
        j = n % len(data.batches)
        y = system.classify(data.batches[j]).cpu()
        done = clock()
        lat.append(done - t)
        sent.append(j)
        outs.append(y.numpy())
        if done <= end:
            items += mix["batch"]
        n += 1
    return Record(seconds=seconds, latencies_s=lat, items=items, attempted=n,
                  work=[("images", mix["batch"])] * n,
                  outputs=(sent, outs))


def release(data: Data) -> None:
    data.batches = None


def _mismatches(data: Data, mix: dict, sent, outs, want) -> int:
    want = want.reshape(len(data.frames), mix["batch"], -1)
    return sum(int((o != want[j]).sum()) for j, o in zip(sent, outs))


def _pool(data: Data) -> np.ndarray:
    return data.frames.reshape(-1, *data.frames.shape[2:])


def check(system, data: Data, mix: dict, rec: Record, reference, limits,
          seed: int) -> List[Check]:
    """Logits that differ from the reference's, over every request."""
    sent, outs = rec.outputs
    want = reference.forward(*system.reference_args, _pool(data))
    return [Check("logit_mismatches", _mismatches(data, mix, sent, outs, want),
                  limits["logit_mismatches"]["limit"])]


def control(system, data: Data, mix: dict, rec: Record, reference,
            seed: int) -> float:
    """The check's number for the reference in the next lower precision
    (int4 weights), put in the program's place for the same requests."""
    sent, _ = rec.outputs
    (tree,) = system.reference_args
    want = reference.forward(tree, _pool(data))
    low = reference.forward(reference.lower_precision(tree), _pool(data))
    low = low.reshape(len(data.frames), mix["batch"], -1)
    return _mismatches(data, mix, sent, [low[j] for j in sent], want)
