"""What the bf16 flash-attention kernel is handed, checked on the CPU.

``repro_torch.kernels.flash_attention.plan`` states the launch in Python:
64-row query tiles, a 2-stage K/V ring, the head dim padded to whole TMA
boxes, the shared memory per block and the grid with its block order. The
CUDA kernel itself runs only on a card (``tests/test_torch_kernels.py``,
``-m gpu``); here the plan, the wrapper's refusals and the plain version at
the kernel's new edge shapes (against the JAX package, Pallas in interpret
mode) are held.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref

F32_TOL = 2e-5


@pytest.mark.parametrize("d", range(16, 257, 16))
def test_plan_fits_shared_memory_and_pads_d_to_whole_boxes(d):
    pl = tfa.plan(4, 512, 512, 16, 8, d)
    assert pl.smem_bytes <= tfa.SMEM_LIMIT
    assert pl.d_pad % tfa.BOX == 0 and d <= pl.d_pad < d + tfa.BOX
    # Q and the ring's K and V tiles, plus alignment slack and barriers
    assert pl.smem_bytes >= pl.block_q * pl.d_pad * 2 * (1 + 2 * pl.stages)
    assert pl.stages >= 2 and pl.block_q == pl.block_k == 64


@pytest.mark.parametrize("b,tq,h,causal", [
    (4, 512, 16, True), (1, 65, 3, True), (2, 509, 16, False), (1, 8, 2, False),
    (3, 64, 1, True),
])
def test_plan_grid_covers_every_tile_once(b, tq, h, causal):
    pl = tfa.plan(b, tq, tq, h, 1, 64, causal=causal)
    n_q = -(-tq // 64)
    assert pl.grid == (n_q, b * h)
    tiles = list(pl.tiles())
    assert len(tiles) == n_q * b * h
    assert set(tiles) == {(qt, bh) for qt in range(n_q) for bh in range(b * h)}


def test_plan_starts_causal_launches_from_the_heaviest_tiles():
    pl = tfa.plan(4, 512, 512, 16, 8, 256)
    order = [qt for qt, _ in pl.tiles()]
    assert order == sorted(order, reverse=True)   # most K/V tiles first
    assert order[0] == 7 and order[-1] == 0
    flat = [qt for qt, _ in tfa.plan(4, 512, 512, 16, 8, 256,
                                     causal=False).tiles()]
    assert flat == sorted(flat)


def test_plan_at_the_gemma2_path_shape():
    pl = tfa.plan(4, 512, 512, 16, 8, 256)
    assert (pl.d_pad, pl.stages, pl.grid) == (256, 2, (8, 64))
    # Q 32 KB + 2 x (K 32 KB + V 32 KB), 1 KB alignment slack, 3 barriers
    assert pl.smem_bytes == 32768 * 5 + 1024 + 24


def _refusal(case):
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    if case == "cpu":
        return (q, q, q), ValueError, "CUDA tensors"
    if case == "d % 16":
        q = torch.zeros(1, 8, 2, 40, dtype=torch.bfloat16)
        return (q, q, q), ValueError, "multiple of 16"
    if case == "d > 256":
        q = torch.zeros(1, 8, 2, 272, dtype=torch.bfloat16)
        return (q, q, q), ValueError, "<= 256"
    if case == "non-contiguous":
        t = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16).transpose(1, 2)
        return (t, t, t), ValueError, "contiguous"
    q = torch.zeros(1, 8, 2, 32, dtype=torch.float16)
    return (q, q, q), TypeError, "float32 or bfloat16"


@pytest.mark.parametrize("case", ["cpu", "d % 16", "d > 256",
                                  "non-contiguous", "float16"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, err, msg = _refusal(case)
    before = tfa.LAUNCHES
    with pytest.raises(err, match=msg):
        tfa.flash_attention_cuda(*args)
    assert tfa.LAUNCHES == before


# The kernel's new edges: d 16 and 128 (d padded to one and two TMA boxes),
# Tk < 64 (one ragged K/V tile), Tq 65 / Tk 129 non-causal with window 48
# (ragged boxes on both edges, rows whose first tiles are skipped).
EDGE_CASES = [
    (64, 64, 16, True, None, None),
    (80, 80, 128, True, None, 50.0),
    (40, 40, 64, True, None, None),
    (48, 20, 32, False, None, None),
    (65, 129, 64, False, 48, None),
]


@pytest.mark.parametrize("tq,tk,d,causal,window,softcap", EDGE_CASES)
def test_attention_ref_matches_jax_at_the_kernel_edges(tq, tk, d, causal,
                                                       window, softcap):
    rng = np.random.default_rng(tq + 3 * tk + d)
    arrays = [rng.standard_normal((2, t, d)).astype(np.float32)
              for t in (tq, tk, tk)]
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.attention_ref(jq, jk, jv, **kw)), atol=F32_TOL, rtol=F32_TOL)
    if tq <= tk or causal:   # the Pallas kernel differs on keyless rows
        np.testing.assert_allclose(got.numpy(), np.asarray(
            flash_attention(jq, jk, jv, interpret=True, **kw)),
            atol=F32_TOL, rtol=F32_TOL)


def test_mha_cpu_matches_jax_gqa_without_window():
    # gemma2's heads (16 / 8, d 256) with window None, at a short ragged P
    rng = np.random.default_rng(11)
    b, t, h, hkv, d = 2, 67, 16, 8, 256
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d))]
    kw = dict(causal=True, window=None, softcap=50.0)
    got = ops.mha(*(torch.from_numpy(a) for a in arrays), n_kv_heads=hkv,
                  **kw)
    want = jops.mha(*(jnp.asarray(a) for a in arrays), n_kv_heads=hkv,
                    interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
