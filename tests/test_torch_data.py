"""The port's synthetic data pipeline (``repro_torch.data``) against the JAX
package's: the cases of tests/test_data.py, and every batch equal to the
reference's array for array (same seed sequence, same numpy draws), for a
token, a vision and an audio config, at several steps and shards.
"""

import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import InputShape as JShape
from repro.data import SyntheticLMData as JData
from repro.data import batch_for_shape as j_batch_for_shape
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.data import (SyntheticLMData, batch_for_shape,
                              make_prefetcher)

CFG = registry.get_smoke("qwen3-14b")
SHAPE = InputShape("train_4k", 16, 8, "train")


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["qwen3-14b", "internvl2-1b",
                                  "hubert-xlarge", "gemma2-9b"])
@pytest.mark.parametrize("shards", [1, 4])
def test_batches_equal_the_reference(arch, shards):
    t_shape, j_shape = InputShape("t", 12, 8, "train"), JShape("t", 12, 8,
                                                                "train")
    for shard in range(shards):
        mine = SyntheticLMData(registry.get_smoke(arch), t_shape, seed=5,
                               n_shards=shards, shard=shard)
        theirs = JData(jreg.get_smoke(arch), j_shape, seed=5,
                       n_shards=shards, shard=shard)
        for step in (0, 1, 17):
            _equal(mine.batch_at(step), theirs.batch_at(step))


def test_batch_for_shape_equals_the_reference():
    _equal(batch_for_shape(registry.get("internvl2-1b"),
                           InputShape("t", 32, 2, "train"), step=3, seed=1),
           j_batch_for_shape(jreg.get("internvl2-1b"),
                             JShape("t", 32, 2, "train"), step=3, seed=1))


def test_batch_at_is_pure():
    d = SyntheticLMData(CFG, SHAPE, seed=3)
    _equal(d.batch_at(5), d.batch_at(5))


def test_different_steps_differ():
    d = SyntheticLMData(CFG, SHAPE, seed=3)
    assert not np.array_equal(d.batch_at(0)["tokens"],
                              d.batch_at(1)["tokens"])


def test_shards_are_disjoint_slices_of_consistent_size():
    parts = [SyntheticLMData(CFG, SHAPE, seed=1, n_shards=4, shard=i)
             for i in range(4)]
    got = [p.batch_at(2)["tokens"] for p in parts]
    assert all(g.shape[0] == SHAPE.global_batch // 4 for g in got)
    assert not np.array_equal(got[0], got[1])
    with pytest.raises(ValueError, match="shard evenly"):
        SyntheticLMData(CFG, SHAPE, n_shards=3)


def test_labels_are_next_tokens():
    b = SyntheticLMData(CFG, SHAPE, seed=0).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_yields_in_step_order():
    d = SyntheticLMData(CFG, SHAPE, seed=9)
    it = make_prefetcher(d.batch_at, start_step=3, depth=2)
    got = [next(it) for _ in range(3)]
    it.close()
    for i, b in enumerate(got):
        _equal(b, d.batch_at(3 + i))


def test_iteration_walks_the_steps():
    d = SyntheticLMData(CFG, SHAPE, seed=2)
    it = iter(d)
    for step in range(3):
        _equal(next(it), d.batch_at(step))
