"""Traffic kind ``generate``: one client sending static batches of prompts
in a closed loop, each request a prefill and then greedy decode steps, its
tokens streamed: every step copies its batch's tokens to the host.

Mix parameters: ``batch``, ``prompt_len``, ``new_tokens`` (tokens a
sequence gets: one from the prefill, the rest from decode steps), ``pool``
(distinct requests drawn from the seed and sent in turn),
``check_sequences`` (how many of the sampled request's sequences the check
reads), ``trace_seconds``. The window counts every token on the host before
it closes, the prefills' included, and stops at the first step past it.
A traced pass profiles decode steps alone: the first request's prefill
runs before the profile starts, its decode steps under it for
``trace_seconds``, and the rest of them after it, so that the check reads
the whole request.
The window keeps the first request's logits (it always completes: a
window is longer than a request); the check runs the reference over a
seeded sample of that request's sequences, prompt and served tokens, and
takes the widest gap by which a served token's reference logit lies below
the reference's best at its position, and the largest relative error of a
position's logits; it compares those that the cell's limits file names.
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


def steps(system, prompt: np.ndarray, new_tokens: int):
    """Yield each step's (tokens (B,) on the host, logits (B, V)): the
    prefill's, then each decode step's."""
    p = prompt.shape[1]
    logits, cache = system.prefill(torch.from_numpy(prompt),
                                   max_len=p + new_tokens - 1)
    tok = logits.argmax(-1)
    yield tok.cpu(), logits
    for s in range(new_tokens - 1):
        logits = system.decode(cache, tok, p + s)
        tok = logits.argmax(-1)
        yield tok.cpu(), logits


def warm(system, data: Data, mix: dict) -> None:
    for i, _ in enumerate(steps(system, data.prompts[0], mix["new_tokens"])):
        if i == 2:
            break


def window(system, data: Data, mix: dict, seconds: float) -> Record:
    served, sent, lat, work, first = [], [], [], [], []
    items, n = 0, 0
    clock = time.perf_counter
    end = clock() + seconds
    p = mix["prompt_len"]
    while clock() < end:
        j = n % len(data.prompts)
        sent.append(j)
        toks = []
        t = clock()
        for i, (tok, logits) in enumerate(steps(system, data.prompts[j],
                                                mix["new_tokens"])):
            done = clock()
            toks.append(tok.numpy())
            if n == 0:
                first.append(logits)
            work.append(("prefill", mix["batch"], p) if i == 0
                        else ("decode", mix["batch"], p + i - 1))
            if i == 0:
                lat.append(done - t)
            if done > end:
                break
            items += mix["batch"]
        served.append(np.stack(toks, axis=1))
        n += 1
    return Record(seconds=seconds, latencies_s=lat, items=items, attempted=n,
                  work=work, outputs=(sent, served, first))


def traced(system, data: Data, mix: dict, seconds: float, profiled):
    """A traced pass: the first request's prefill, its decode steps under
    ``profiled`` for ``seconds``, then the rest of them; returns (record of
    the profiled steps, profiler, window seconds)."""
    p, b = mix["prompt_len"], mix["batch"]
    it = steps(system, data.prompts[0], mix["new_tokens"])
    tok, logits = next(it)
    toks, first, work = [tok.numpy()], [logits], []
    clock = time.perf_counter

    def decode():
        end = clock() + seconds
        for i, (tok, logits) in enumerate(it, 1):
            toks.append(tok.numpy())
            first.append(logits)
            work.append(("decode", b, p + i - 1))
            if clock() > end:
                break
    _, prof, wall = profiled(decode)
    for tok, logits in it:
        toks.append(tok.numpy())
        first.append(logits)
    rec = Record(seconds=wall, latencies_s=[], items=b * len(work),
                 attempted=1, work=work,
                 outputs=([0], [np.stack(toks, axis=1)], first))
    return rec, prof, wall


def release(data: Data) -> None:
    pass


def sample(data: Data, mix: dict, rec: Record, seed: int):
    """(token sequences, positions, served tokens, served logits) of the
    sequences that the check reads: a seeded sample of the first request's,
    the one whose logits the window kept."""
    sent, served, first = rec.outputs
    i = 0
    toks = served[i]                                   # (batch, n)
    rng = np.random.default_rng([seed, 2])
    rows = np.sort(rng.choice(len(toks), size=min(mix["check_sequences"],
                                                  len(toks)), replace=False))
    p, n = mix["prompt_len"], toks.shape[1]
    seqs = np.concatenate([data.prompts[sent[i]][rows], toks[rows, :-1]],
                          axis=1)
    rows_t = torch.from_numpy(rows).to(data.device)
    return (torch.from_numpy(seqs).to(data.device),
            list(range(p - 1, p + n - 1)),
            torch.from_numpy(toks[rows]).to(data.device),
            torch.stack([lg[rows_t].float() for lg in first], dim=1))


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
    put in the program's place on the same sequences: the gap of the token
    it puts first at each position, and its logits' error."""
    seqs, positions, _, _ = sample(data, mix, rec, seed)
    ref = reference.logits(*system.reference_args, seqs, positions)
    low = reference.logits(*system.reference_args, seqs, positions,
                           cast=reference.fp8_matrix)
    return reference.compare(ref, low.argmax(-1), low)
