"""The control, the reference in the next lower precision put in the
program's place, comes out as not correct where the program comes out as
correct: at smoke sizes on the CPU, and at the cells' own sizes on the card
(``-m gpu``) on three seeds."""

import pytest
import torch

from bench import harness, readings


def _fails(p, reading) -> bool:
    """Whether a reading (a number, or numbers by name) fails a limit."""
    if not isinstance(reading, dict):
        reading = {name: reading for name in p.limits}
    return any(v > p.limits[k]["limit"] for k, v in reading.items()
               if k in p.limits)


@pytest.mark.parametrize("cell", ["mbv2-vww-int8.frame_b1",
                                  "mbv2-vww-int8.offline_b256",
                                  "glm4-9b.prefill_1500",
                                  "glm4-9b.decode_b16"])
def test_control_reads_above_the_program_on_the_cpu(smoke_root, cell):
    p = harness.plan(cell, smoke_root)
    out = readings.readings(p, 2**31 + 41, 0.5, True, "cpu")
    if "arch" in p.cfg:
        # smoke width: the control's logits err several times the bf16
        # program's
        ctl, prog = out["control"], out["program"]
        assert ctl["logit_rel_err"] > 3 * prog["logit_rel_err"]
    else:
        assert out["program"]["logit_mismatches"] == 0
        assert out["control"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell,seconds", [("mbv2-vww-int8.frame_b1", 2),
                                          ("mbv2-vww-int8.offline_b256", 2),
                                          ("glm4-9b.prefill_1500", 4),
                                          ("glm4-9b.decode_b16", 14)])
def test_control_fails_at_the_cells_size(cell, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = harness.plan(cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = readings.readings(p, seed, seconds, True, "cuda")
        assert not _fails(p, out["program"]), out
        assert _fails(p, out["control"]), out
