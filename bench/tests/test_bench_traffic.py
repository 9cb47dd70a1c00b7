"""The same seed gives the same traffic and weights; another seed other
ones."""

import json

import numpy as np
import pytest
import torch

from bench import harness

MIXES = ("frame_b1", "offline_b256", "prefill_1500", "decode_b16")


def _inputs(root, cell, seed):
    p = harness.plan(cell, root)
    data = p.kind.inputs(p.mix, p.cfg, harness.seed_key(seed), "cpu")
    return data.frames if hasattr(data, "frames") else data.prompts


@pytest.mark.parametrize("cell", ["mbv2-vww-int8.frame_b1",
                                  "mbv2-vww-int8.offline_b256",
                                  "glm4-9b.prefill_1500",
                                  "glm4-9b.decode_b16"])
def test_same_seed_same_traffic(smoke_root, cell):
    a = _inputs(smoke_root, cell, 2**31 + 17)
    assert np.array_equal(a, _inputs(smoke_root, cell, 2**31 + 17))
    assert not np.array_equal(a, _inputs(smoke_root, cell, 2**31 + 18))


def test_same_seed_same_weights(smoke_root):
    for cell in ("mbv2-vww-int8.frame_b1", "glm4-9b.prefill_1500"):
        p = harness.plan(cell, smoke_root)
        leaves = []
        for seed in (5, 5, 6):
            s = p.family.System(p.cfg, seed, "cpu")
            tree = s.reference_args[0]
            leaf = (tree["blocks"][3]["w_proj"] if "blocks" in tree
                    else tree["units"]["0"]["sub2"]["w_down"])
            leaves.append(leaf.float() if isinstance(leaf, torch.Tensor)
                          else torch.from_numpy(np.asarray(leaf)).float())
        assert torch.equal(leaves[0], leaves[1])
        assert not torch.equal(leaves[0], leaves[2])


def test_mixes_are_data(smoke_root):
    """Every mix names a traffic kind that a module implements."""
    for name in MIXES:
        mix = json.loads((smoke_root / "bench" / "workloads" /
                          f"{name}.json").read_text())
        assert (smoke_root / "bench" / "traffic" /
                f"{mix['kind']}.py").is_file()
