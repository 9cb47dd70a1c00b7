"""The afmoe LM's useful FLOPs in the traced window over the window times
the card's bf16 peak (%), counted by ``cost_afmoe``: the k routed experts,
the shared expert and the router in the MoE layers, the dense FFN in the
leading ones, attention at each position's own context (the window's on
the sliding layers), the head where a token is produced. ``mfu.py``
counts a dense FFN in every layer and would be wrong here."""

from bench import cost_afmoe


def read(v):
    t = v.trace
    if t is None or t.window_s <= 0 or not v.rec.work:
        return None
    ops = sum(cost_afmoe.work_ops(v.cfg, w) for w in v.rec.work)
    return 100.0 * ops / (t.window_s * v.peaks["bf16_flops"])
