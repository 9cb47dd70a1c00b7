"""Traffic kind ``prefill``: one client sending prompts in a closed loop,
each request one prefill and its first token, sent when the last request's
token is on the host.

Mix parameters: ``batch`` (prompts a request), ``prompt_len``, ``pool``
(distinct requests drawn from the seed and sent in turn), ``check_requests``
(how many served requests the check samples), ``trace_seconds``. A request
runs from the prompt ids on the host through ``lm.prefill`` and the argmax
until the first token is on the host. The check runs the reference over a
seeded sample of the requests served and takes, over the sample, the widest
gap by which a served token's reference logit lies below the reference's
best at its position, and the largest relative error of the served logits
(each request's logits stay on the device until the check); it compares
those that the cell's limits file names.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from bench.harness import Check, Record


class Data:
    def __init__(self, prompts: np.ndarray, device):
        self.prompts = prompts            # (pool, batch, prompt_len) ids
        self.device = device


def inputs(mix: dict, cfg: dict, seed: int, device) -> Data:
    rng = np.random.default_rng([seed, 1])
    return Data(rng.integers(0, cfg["arch"]["vocab"], (
        mix["pool"], mix["batch"], mix["prompt_len"]), dtype=np.int64),
        device)


def request(system, prompt: np.ndarray):
    """(first tokens on the host, the last position's logits)."""
    logits, cache = system.prefill(torch.from_numpy(prompt),
                                   max_len=prompt.shape[1])
    del cache
    return logits.argmax(-1).cpu(), logits


def warm(system, data: Data, mix: dict) -> None:
    for _ in range(2):
        request(system, data.prompts[0])


def window(system, data: Data, mix: dict, seconds: float) -> Record:
    lat, sent, outs, logits = [], [], [], []
    items, n = 0, 0
    clock = time.perf_counter
    end = clock() + seconds
    while clock() < end:
        j = n % len(data.prompts)
        t = clock()
        tok, lg = request(system, data.prompts[j])
        done = clock()
        lat.append(done - t)
        sent.append(j)
        outs.append(tok.numpy())
        logits.append(lg)
        if done <= end:
            items += mix["batch"]
        n += 1
    work = [("prefill", mix["batch"], mix["prompt_len"])] * n
    return Record(seconds=seconds, latencies_s=lat, items=items, attempted=n,
                  work=work, outputs=(sent, outs, logits))


def release(data: Data) -> None:
    pass


def sample(data: Data, mix: dict, rec: Record, seed: int):
    """(token sequences, positions, served tokens, served logits) of the
    seeded sample of requests that the check reads."""
    sent, outs, logits = rec.outputs
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(len(sent), size=min(mix["check_requests"], len(sent)),
                      replace=False)
    seqs = np.concatenate([data.prompts[sent[i]] for i in pick])
    served = np.concatenate([outs[i] for i in pick])[:, None]
    return (torch.from_numpy(seqs).to(data.device), [mix["prompt_len"] - 1],
            torch.from_numpy(served).to(data.device),
            torch.cat([logits[i] for i in pick]).float()[:, None])


def check(system, data: Data, mix: dict, rec: Record, reference, limits,
          seed: int) -> List[Check]:
    seqs, positions, served, logits = sample(data, mix, rec, seed)
    ref = reference.logits(*system.reference_args, seqs, positions)
    got = reference.compare(ref, served, logits[..., :ref.shape[-1]])
    return [Check(k, v, limits[k]["limit"]) for k, v in got.items()
            if k in limits]


def control(system, data: Data, mix: dict, rec: Record, reference,
            seed: int) -> dict:
    """The check's numbers for the reference in the next lower precision,
    put in the program's place on the same sample: the gap of the token it
    puts first, and its logits' error."""
    seqs, positions, _, _ = sample(data, mix, rec, seed)
    ref = reference.logits(*system.reference_args, seqs, positions)
    low = reference.logits(*system.reference_args, seqs, positions,
                           cast=reference.fp8_matrix)
    return reference.compare(ref, low.argmax(-1), low)
