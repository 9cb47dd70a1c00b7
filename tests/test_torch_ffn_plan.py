"""What the fused-FFN kernel is handed, checked on the CPU.

``repro_torch.kernels.fused_ffn.plan`` states each launch in Python: in
bf16 a cluster of C blocks along d_model, each holding 64 token rows x
``cols`` output columns in registers, walking its d_ff group in chunks of
C x 64 columns whose h pieces are all-gathered in distributed shared
memory; the ring depth, the shared memory, the grid and the workspace (none
at prefill, f32 partials of the d_ff groups at decode). A d_model wider than
one cluster covers (3584) is cut into slices along the grid's x, one cluster
each, that recompute the expansion. The CUDA kernel
runs only on a card (``tests/test_torch_kernels.py``, ``-m gpu``, and
``chip_smoke.py``, which also holds the built launcher's plan to this one).
Here the plan's coverage and sizes, the wrapper's refusals, and a plain
torch emulation of the plan's tile walk (against the plain version and the
JAX package) are held.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import ref

N_SM = 132                   # an H100 SXM
D_MODEL, D_FF = 3584, 14336  # gemma2-9b
BF16_TOL = 2e-2              # tests/test_kernels.py's bf16 tolerance
BF16_NORM_TOL = 1e-2         # relative norm of the whole output
REG_LIMIT = 232              # a consumer thread's registers after setmaxnreg

# The wider dense configs: (d_model, d_ff) of glm4-9b, qwen3-14b, qwen2-72b.
WIDE = [(4096, 13696), (5120, 17408), (8192, 29568)]
# (T, d_model, d_ff): the gemma2-9b serve path (decode T 1 and 4, prefill
# T 2048, a ragged prefill T 1000), the card test's shapes, a ragged d_ff;
# the wide configs' decode and prefill, a ragged T, and small shapes just
# past one cluster's cover (counted element by element).
SHAPES = [(1, D_MODEL, D_FF), (4, D_MODEL, D_FF), (77, D_MODEL, D_FF),
          (1000, D_MODEL, D_FF), (2048, D_MODEL, D_FF),
          (64, 128, 512), (32, 64, 192), (128, 128, 384), (64, 96, 256),
          (1, 256, 1040), (77, D_MODEL, 1024), (48, 128, 256)]
SHAPES += [(t, d, f) for d, f in WIDE for t in (4, 2048)]
SHAPES += [(1000, 5120, 17408), (3, 3600, 128), (70, 8192, 48),
           (5, 7184, 64)]


def _ranges(pl):
    """The plan's distinct token-row, d_ff and d_model ranges, and its
    blocks as (tile, group, block x)."""
    rows, ffs, cols, blocks = {}, {}, {}, []
    for x, tile, group, ff, dm in pl.tiles():
        rows[tile] = (tile * pl.block_t, (tile + 1) * pl.block_t)
        ffs[group], cols[x] = ff, dm
        blocks.append((tile, group, x))
    return rows, ffs, cols, blocks


def _partition(ranges, n, past_ok=()):
    """Half-open ranges, in key order, tile [0, >= n) with no gap or overlap
    and none wholly past n but those keyed in ``past_ok``."""
    spans = [ranges[k] for k in sorted(ranges)]
    assert spans[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] >= n
    assert all(lo < n for k, (lo, _) in ranges.items() if k not in past_ok)


@pytest.mark.parametrize("t,d,f", SHAPES)
def test_plan_covers_every_row_ff_column_and_model_column_once(t, d, f):
    pl = tff.plan(t, d, f, torch.bfloat16, N_SM)
    rows, ffs, cols, blocks = _ranges(pl)
    # every block is one (token tile, d_ff group, d_model slice), each once
    assert len(blocks) == len(set(blocks)) == (
        pl.grid[0] * pl.grid[1] * pl.grid[2])
    assert set(blocks) == {(a, b, c) for a in rows for b in ffs for c in cols}
    _partition(rows, t)
    _partition(ffs, f)
    # a block wholly past d_model exists only where a sliced d_model leaves
    # the last slice's cluster wider than its columns: the cluster still
    # needs that block's h pieces
    last = range((pl.slices - 1) * pl.cluster, pl.grid[0]) if (
        pl.slices > 1) else ()
    _partition(cols, d, last)
    assert pl.grid == (pl.cluster * pl.slices, len(rows), pl.groups)
    # a group walks whole chunks; a chunk is one 64-column piece per block
    assert pl.chunk == 64 * pl.cluster
    assert all((hi - lo) % pl.chunk == 0 for lo, hi in ffs.values())
    if t * d * f <= 2 ** 25:   # and, counted element by element
        count = np.zeros((t, f, d), np.int8)
        for _, tile, group, (f0, f1), (n0, n1) in pl.tiles():
            count[tile * 64:(tile + 1) * 64, f0:f1, n0:n1] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("d", [16, 48, 64, 96, 128, 208, 256, 448, 464,
                               512, 896, 1024, 1792, 2048, 2304, 3072, 3584,
                               3600, 4096, 5120, 7168, 7184, 8192])
def test_plan_fits_shared_memory_and_registers(d):
    pl = tff.plan(2048, d, 4 * d, torch.bfloat16, N_SM)
    assert pl.smem_bytes <= tff.SMEM_LIMIT
    assert pl.cluster in (1, 2, 4, 8) and pl.cols // 2 in tff.WIDTHS
    # one slice where a cluster covers d_model, else the fewest slices
    assert pl.slices == (1 if d <= tff.MAX_COVER else -(-d // tff.MAX_COVER))
    assert pl.grid[0] == pl.slices * pl.cluster
    # the smallest cluster, then the smallest width, that covers a slice
    per = -(-d // pl.slices)
    assert pl.cluster * pl.cols >= per
    if pl.cluster > 1:
        assert pl.cluster // 2 * 2 * tff.WIDTHS[-1] < per
    narrower = [w for w in tff.WIDTHS if w < pl.cols // 2]
    if narrower:
        assert pl.cluster * 2 * narrower[-1] < per
    # the ring (at least double-buffered) and the h chunk buffer
    slot = max(2 * tff.X_BOX + 4 * tff.W_BOX, tff.PROJ_K * pl.cols * 2)
    assert pl.stages >= 2
    assert pl.smem_bytes >= pl.stages * slot + pl.cluster * tff.H_PIECE
    # the accumulators and [g | u], with room for addressing and the mix
    assert pl.acc_registers + 64 <= REG_LIMIT


@pytest.mark.parametrize("d,f", WIDE)
def test_plan_refuses_a_model_wider_than_the_widest_cluster(d, f):
    """One cluster refuses a d_model past 3584 columns; the plan cuts it
    into slices of one cluster each, which cover every token row, d_ff
    column and d_model column exactly once, at decode and at prefill."""
    with pytest.raises(ValueError, match="up to 3584 columns"):
        tff.pick_width(d)
    for t in (4, 2048):
        pl = tff.plan(t, d, f, torch.bfloat16, N_SM)
        assert pl.slices == -(-d // 3584) > 1
        blocks = {}
        for x, tile, group, ff, dm in pl.tiles():
            assert (tile, group, x) not in blocks
            blocks[tile, group, x] = ff + dm
        tiles = sorted({tile for tile, _, _ in blocks})
        assert tiles == list(range(-(-t // 64)))
        for tile in tiles:   # d_ff x d_model, in 16 x 16 cells, once each
            cells = np.zeros((-(-f // 16), d // 16), np.int8)
            for (tl, _, _), (f0, f1, n0, n1) in blocks.items():
                if tl == tile:
                    cells[f0 // 16:f1 // 16, n0 // 16:n1 // 16] += 1
            assert (cells == 1).all()


@pytest.mark.parametrize("t", [2048, 1000])
def test_prefill_plan_has_one_group_and_no_workspace(t):
    pl = tff.plan(t, D_MODEL, D_FF, torch.bfloat16, N_SM)
    assert pl.groups == 1 and pl.ws_bytes == 0
    assert (pl.cluster, pl.cols, pl.chunk, pl.chunks) == (8, 448, 512, 28)
    assert pl.grid == (8, -(-t // 64), 1)
    assert pl.acc_registers == 448 // 4 + 32   # 112 of output, 32 of [g | u]


@pytest.mark.parametrize("t", [1, 4])
def test_decode_workspace_is_under_one_percent_of_the_weights(t):
    pl = tff.plan(t, D_MODEL, D_FF, torch.bfloat16, N_SM)
    weight_bytes = 3 * D_MODEL * D_FF * 2
    assert pl.groups > 1
    assert pl.ws_bytes == 4 * pl.groups * t * D_MODEL
    assert pl.ws_bytes < 0.01 * weight_bytes
    # the groups spread the weights over the card without a second wave
    assert pl.groups * pl.cluster <= N_SM
    assert pl.groups * pl.cluster * 2 > N_SM


def test_gemma2_path_plans_are_pinned():
    assert tff.plan(2048, D_MODEL, D_FF, torch.bfloat16, N_SM) == tff.Plan(
        block_t=64, cluster=8, cols=448, chunk=512, stages=3, groups=1,
        per_group=28, chunks=28, smem_bytes=214_128, grid=(8, 32, 1),
        ws_bytes=0)
    assert tff.plan(4, D_MODEL, D_FF, torch.bfloat16, N_SM) == tff.Plan(
        block_t=64, cluster=8, cols=448, chunk=512, stages=3, groups=14,
        per_group=2, chunks=28, smem_bytes=214_128, grid=(8, 1, 14),
        ws_bytes=802_816)


@pytest.mark.parametrize("d,f,cols,chunks,slices,decode_groups", [
    (4096, 13696, 256, 27, 2, 7), (5120, 17408, 448, 34, 2, 7),
    (8192, 29568, 448, 58, 3, 5)])
def test_wide_plans_are_pinned(d, f, cols, chunks, slices, decode_groups):
    """glm4-9b, qwen3-14b and qwen2-72b: clusters of 8 side by side, the
    gemma2 ring and shared memory; one group at prefill, and at decode the
    groups that fill the card with the slices' clusters."""
    pre = tff.plan(2048, d, f, torch.bfloat16, N_SM)
    assert pre == tff.Plan(
        block_t=64, cluster=8, cols=cols, chunk=512, stages=3, groups=1,
        per_group=chunks, chunks=chunks, smem_bytes=214_128,
        grid=(8 * slices, 32, 1), ws_bytes=0)
    dec = tff.plan(4, d, f, torch.bfloat16, N_SM)
    assert (dec.slices, dec.groups, dec.grid) == (
        slices, decode_groups, (8 * slices, 1, decode_groups))
    assert dec.ws_bytes == 4 * decode_groups * 4 * d
    assert dec.groups * dec.grid[0] <= N_SM


def _refusal(case):
    bf = torch.bfloat16
    x, wg, wu = (torch.zeros(s, dtype=bf) for s in ((4, 64), (64, 128),
                                                    (64, 128)))
    wd = torch.zeros(128, 64, dtype=bf)
    args, err, msg = [x, wg, wu, wd], ValueError, None
    if case == "cpu":
        msg = "CUDA tensors"
    elif case == "x 3-d":
        args[0], msg = torch.zeros(1, 4, 64, dtype=bf), r"\(T, d_model\)"
    elif case == "d % 16":
        args = [torch.zeros(s, dtype=bf) for s in ((4, 72), (72, 128),
                                                   (72, 128), (128, 72))]
        msg = "multiples of 16"
    elif case == "float16":
        args = [a.half() for a in args]
        err, msg = TypeError, "float32 or bfloat16"
    elif case == "mixed dtypes":
        args[3] = wd.float()
        err, msg = TypeError, "w_down has dtype"
    elif case == "w_down shape":
        args[3], msg = torch.zeros(64, 128, dtype=bf), "w_down has shape"
    elif case == "non-contiguous":
        args[2] = torch.zeros(128, 64, dtype=bf).T
        msg = "w_up must be contiguous"
    elif case == "misaligned":
        args[0] = torch.zeros(4 * 64 + 1, dtype=bf)[1:].view(4, 64)
        msg = "16-byte boundaries"
    elif case == "d_model > 3584":
        # a wide d_model is taken (sliced): only the CPU tensors are refused
        args = [torch.zeros(s, dtype=bf) for s in ((4, 3600), (3600, 64),
                                                   (3600, 64), (64, 3600))]
        msg = "CUDA tensors"
    elif case == "d_ff % 16":
        args = [torch.zeros(s, dtype=bf) for s in ((4, 64), (64, 72),
                                                   (64, 72), (72, 64))]
        msg = "multiples of 16"
    return args, err, msg


@pytest.mark.parametrize("case", ["cpu", "x 3-d", "d % 16", "float16",
                                  "mixed dtypes", "w_down shape",
                                  "non-contiguous", "misaligned",
                                  "d_model > 3584", "d_ff % 16"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, err, msg = _refusal(case)
    before = tff.LAUNCHES
    with pytest.raises(err, match=msg):
        tff.fused_ffn_cuda(*args, act="gelu")
    assert tff.LAUNCHES == before


def _emulate(x, wg, wu, wd, act, pl):
    """The bf16 plan's tile walk in plain torch: for each token tile and
    d_ff chunk, every block's 64-column h piece (f32 products, act(g) * u
    in f32, cast to bf16), the all-gather of the pieces into the chunk,
    each block's projection of the chunk onto its columns into an f32
    accumulator, chunk after chunk (every d_model slice's cluster computes
    the same pieces); then the groups' partials summed in group order and
    cast to bf16."""
    t, d = x.shape
    f = wu.shape[1]
    fn = ref.ACTS[act]
    f_pad = pl.chunks * pl.chunk
    d_pad = pl.grid[0] * pl.cols
    xf = torch.zeros(pl.grid[1] * 64, d)
    xf[:t] = x.float()

    def pad(w, shape):
        out = torch.zeros(shape)
        out[:w.shape[0], :w.shape[1]] = w.float()
        return out

    wgf = None if wg is None else pad(wg, (d, f_pad))
    wuf, wdf = pad(wu, (d, f_pad)), pad(wd, (f_pad, d_pad))
    partial = torch.zeros(pl.groups, t, d)
    for group in range(pl.groups):
        c0 = group * pl.per_group
        c1 = min(pl.chunks, c0 + pl.per_group)
        for tile in range(pl.grid[1]):
            rows = slice(tile * 64, (tile + 1) * 64)
            acc = [torch.zeros(64, pl.cols) for _ in range(pl.grid[0])]
            for c in range(c0, c1):
                pieces = []
                for rank in range(pl.cluster):
                    cols = slice(c * pl.chunk + rank * 64,
                                 c * pl.chunk + (rank + 1) * 64)
                    u = xf[rows] @ wuf[:, cols]
                    h = fn(u) if wgf is None else fn(xf[rows] @ wgf[:, cols]) * u
                    pieces.append(h.to(torch.bfloat16))
                chunk = torch.cat(pieces, 1).float()   # the all-gather
                for bx in range(pl.grid[0]):
                    n = slice(bx * pl.cols, (bx + 1) * pl.cols)
                    acc[bx] += chunk @ wdf[c * pl.chunk:(c + 1) * pl.chunk, n]
            out = torch.cat(acc, 1)[:, :d]
            n_rows = min(64, t - tile * 64)
            partial[group, tile * 64:tile * 64 + n_rows] = out[:n_rows]
    y = partial[0]
    for group in range(1, pl.groups):   # the fixed order of reduce_kernel
        y = y + partial[group]
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("t,d,f,act,gated", [
    (64, 128, 512, "silu", True), (32, 64, 192, "gelu", True),
    (128, 128, 384, "relu_sq", True), (64, 96, 256, "gelu", False),
    (1, 256, 1040, "relu", True), (48, 128, 256, "relu", True),
    (77, D_MODEL, 1024, "gelu", True), (4, D_MODEL, 1024, "gelu", True),
    (4, 4096, 512, "silu", True), (70, 3600, 256, "silu", True),
    (3, 5120, 512, "silu", True), (2, 8192, 256, "gelu", False)])
def test_tile_walk_emulation_matches_plain_version_and_jax(t, d, f, act,
                                                           gated):
    rng = np.random.default_rng(t + d + f)
    x = rng.standard_normal((t, d))
    ws = [rng.standard_normal(s) * min(0.05, s[0] ** -0.5)
          for s in ((d, f), (d, f), (f, d))]
    tx, tg, tu, td = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                      for a in (x, *ws))
    tg = tg if gated else None
    pl = tff.plan(t, d, f, torch.bfloat16, N_SM)
    got = _emulate(tx, tg, tu, td, act, pl)
    want = ref.fused_ffn_ref(tx, tg, tu, td, act=act)
    jx, jg, ju, jd = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                      for a in (tx, tg if gated else tu, tu, td))
    jwant = np.asarray(jref.fused_ffn_ref(jx, jg if gated else None, ju, jd,
                                          act=act).astype(jnp.float32))
    for other in (want.float().numpy(), jwant):
        np.testing.assert_allclose(got.float().numpy(), other,
                                   atol=BF16_TOL, rtol=BF16_TOL)
        rel = np.linalg.norm(got.float().numpy() - other) / np.linalg.norm(other)
        assert rel < BF16_NORM_TOL
