"""What the fused-FFN kernel is handed, checked on the CPU.

``repro_torch.kernels.fused_ffn.plan`` decides each launch: in
bf16 a cluster of C blocks along d_model, each holding 64 token rows x
``cols`` output columns in registers, walking its d_ff group in chunks of
C x 64 columns whose h pieces are all-gathered in distributed shared
memory; the ring depth, the shared memory, the grid and the workspace (f32
partials of the d_ff groups: at decode, and at prefill where the token
tiles' clusters would leave their last wave part empty; else none). One
cluster covers up to 4096 columns (256 a warpgroup at a cluster of 8); a
d_model wider is cut into slices along the grid's x, one cluster each, that
recompute the expansion. The CUDA kernel
runs only on a card (``tests/test_torch_kernels.py``, ``-m gpu``, and
``chip_smoke.py``); its launcher takes this plan's numbers or refuses them.
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
RESIDENT = 15                # clusters of 8 resident at once on it
D_MODEL, D_FF = 3584, 14336  # gemma2-9b
BF16_TOL = 2e-2              # tests/test_kernels.py's bf16 tolerance
BF16_NORM_TOL = 1e-2         # relative norm of the whole output
REG_LIMIT = 232              # a consumer thread's registers after setmaxnreg

# The wider dense configs: (d_model, d_ff) of glm4-9b, qwen3-14b, qwen2-72b.
WIDE = [(4096, 13696), (5120, 17408), (8192, 29568)]
GLM4 = WIDE[0]
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
# the glm4-9b cells' launches: a prefill of 1,500 ids, a decode_b16 batch's
# prefill of 16 x 1,020 and its steps of 16
SHAPES += [(1500, *GLM4), (16320, *GLM4), (16, *GLM4)]


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


@pytest.mark.parametrize("resident", [4, RESIDENT])
@pytest.mark.parametrize("t,d,f", SHAPES)
def test_plan_covers_every_row_ff_column_and_model_column_once(t, d, f,
                                                               resident):
    pl = tff.plan(t, d, f, torch.bfloat16, N_SM, resident)
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
    pl = tff.plan(2048, d, 4 * d, torch.bfloat16, N_SM, RESIDENT)
    assert pl.smem_bytes <= tff.SMEM_LIMIT
    assert pl.cluster in (1, 2, 4, 8) and pl.cols // 2 in tff.WIDTHS
    # one slice where a cluster covers d_model, else the fewest slices
    assert pl.slices == (1 if d <= tff.MAX_COVER else -(-d // tff.MAX_COVER))
    assert pl.grid[0] == pl.slices * pl.cluster
    # the smallest cluster, then the smallest width, that covers a slice;
    # the widest only at a full cluster, where the next does not cover
    per = -(-d // pl.slices)
    assert pl.cluster * pl.cols >= per
    if pl.cluster > 1:
        assert pl.cluster // 2 * 2 * tff.WIDTHS[-2] < per
    assert pl.cols // 2 < tff.WIDTHS[-1] or pl.cluster == tff.MAX_CLUSTER
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
    """One cluster takes a d_model up to 4096 columns (glm4-9b: 8 blocks of
    512) and refuses one past it; the plan cuts that into slices of one
    cluster each. Either way every token row, d_ff column and d_model
    column is covered exactly once, at decode and at prefill."""
    if d <= 4096:
        assert tff.pick_width(d) == (8, 256)
    else:
        with pytest.raises(ValueError, match="up to 4096 columns"):
            tff.pick_width(d)
    for t in (4, 2048):
        pl = tff.plan(t, d, f, torch.bfloat16, N_SM, RESIDENT)
        assert pl.slices == -(-d // 4096)
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


@pytest.mark.parametrize("t,d,f,cols,chunks", [
    (16320, *GLM4, 512, 27), (8192, 2048, 6144, 256, 12)])
def test_prefill_plan_has_one_group_and_no_workspace(t, d, f, cols, chunks):
    """Where the token tiles' clusters leave no wave much emptier than a
    cut of d_ff would (a glm4-9b decode_b16 batch's prefill of 16 x 1,020,
    trinity-mini's dense lead layer at 8,192): the kernel writes y and
    nothing else."""
    pl = tff.plan(t, d, f, torch.bfloat16, N_SM, RESIDENT)
    assert pl.groups == 1 and pl.ws_bytes == 0
    assert (pl.cluster, pl.cols, pl.chunk, pl.chunks) == (8, cols, 512,
                                                          chunks)
    assert pl.grid == (8, -(-t // 64), 1)
    # output columns, then 32 of [g | u]
    assert pl.acc_registers == cols // 4 + 32


@pytest.mark.parametrize("t", [1, 4])
def test_decode_workspace_is_under_one_percent_of_the_weights(t):
    pl = tff.plan(t, D_MODEL, D_FF, torch.bfloat16, N_SM, RESIDENT)
    weight_bytes = 3 * D_MODEL * D_FF * 2
    assert pl.groups > 1
    assert pl.ws_bytes == 4 * pl.groups * t * D_MODEL
    assert pl.ws_bytes < 0.01 * weight_bytes
    # the groups spread the weights over the card without a second wave
    assert pl.groups * pl.cluster <= N_SM
    assert pl.groups * pl.cluster * 2 > N_SM


def test_gemma2_path_plans_are_pinned():
    """The launches on an H100: at T 2048 the 32 token tiles' clusters, 15
    at a time, take 4 d_ff groups (128 clusters of 7 chunks in 9 waves, 63,
    not 3 waves of 28, 84), whose f32 partials a second pass sums."""
    assert tff.plan(2048, D_MODEL, D_FF, torch.bfloat16, N_SM,
                    RESIDENT) == tff.Plan(
        block_t=64, cluster=8, cols=448, chunk=512, stages=3, groups=4,
        per_group=7, chunks=28, smem_bytes=214_128, grid=(8, 32, 4),
        ws_bytes=117_440_512)
    assert tff.plan(4, D_MODEL, D_FF, torch.bfloat16, N_SM,
                    RESIDENT) == tff.Plan(
        block_t=64, cluster=8, cols=448, chunk=512, stages=3, groups=14,
        per_group=2, chunks=28, smem_bytes=214_128, grid=(8, 1, 14),
        ws_bytes=802_816)


@pytest.mark.parametrize(
    "d,f,cols,chunks,slices,prefill_groups,per_group,decode_groups", [
        (4096, 13696, 512, 27, 1, 3, 9, 14),
        (5120, 17408, 448, 34, 2, 2, 17, 7),
        (8192, 29568, 512, 58, 2, 3, 20, 8)])
def test_wide_plans_are_pinned(d, f, cols, chunks, slices, prefill_groups,
                               per_group, decode_groups):
    """glm4-9b, qwen3-14b and qwen2-72b on an H100: one cluster of 8 at
    4096 columns (256 a warpgroup), clusters of 8 side by side past it, the
    gemma2 ring and shared memory; at prefill T 2048 the d_ff groups that
    fill the last wave of the 15 resident clusters, and at decode the
    groups that fill the card with the slices' clusters."""
    pre = tff.plan(2048, d, f, torch.bfloat16, N_SM, RESIDENT)
    assert pre == tff.Plan(
        block_t=64, cluster=8, cols=cols, chunk=512, stages=3,
        groups=prefill_groups, per_group=per_group, chunks=chunks,
        smem_bytes=214_128, grid=(8 * slices, 32, prefill_groups),
        ws_bytes=4 * prefill_groups * 2048 * d)
    dec = tff.plan(4, d, f, torch.bfloat16, N_SM, RESIDENT)
    assert (dec.slices, dec.groups, dec.grid) == (
        slices, decode_groups, (8 * slices, 1, decode_groups))
    assert dec.ws_bytes == 4 * decode_groups * 4 * d
    assert dec.groups * dec.grid[0] <= N_SM


@pytest.mark.parametrize("t,groups", [(16, 14), (1500, 3), (16320, 1)])
def test_glm4_cells_run_one_slice_and_cover_each_element_once(t, groups):
    """glm4-9b's launches in its cells: one cluster of 8 blocks of 512
    columns covers d_model (no expansion recomputed); at T 1500 the 24
    token tiles' clusters, 15 at a time, take 3 d_ff groups (72 clusters of
    9 chunks in 5 waves, not 2 waves of 27 chunks); a batch's prefill of
    16,320 rows stays one group. Every token row, d_ff column and d_model
    column is covered once."""
    d, f = GLM4
    pl = tff.plan(t, d, f, torch.bfloat16, N_SM, RESIDENT)
    assert (pl.slices, pl.cluster, pl.cols, pl.chunks) == (1, 8, 512, 27)
    assert pl.groups == groups
    assert pl.ws_bytes == (4 * groups * t * d if groups > 1 else 0)
    rows, ffs, cols, blocks = _ranges(pl)
    assert len(blocks) == len(set(blocks)) == len(rows) * len(ffs) * 8
    _partition(rows, t)
    _partition(ffs, f)
    _partition(cols, d)
    assert max(hi for _, hi in cols.values()) == d   # no column past d


@pytest.mark.parametrize("t,d,f,groups", [
    (1500, *GLM4, 3), (2048, *GLM4, 3), (1000, *GLM4, 4),
    (2048, D_MODEL, D_FF, 4), (8192, *GLM4, 1), (8192, 2048, 6144, 1),
    (2048, 5120, 17408, 2)])
def test_prefill_groups_fill_the_last_wave(t, d, f, groups):
    """Where the token tiles' clusters fill the card, d_ff is cut into at
    most 4 groups when that saves a tenth of the waves x chunks a cluster
    walks; the groups are the cheapest such cut, and none where no cut
    saves a tenth (trinity-mini's 128 tiles at d 2048: 108 against 104)."""
    pl = tff.plan(t, d, f, torch.bfloat16, N_SM, RESIDENT)
    assert pl.groups == groups

    def cost(per):
        n = -(-pl.chunks // per)
        return -(-pl.slices * pl.grid[1] * n // RESIDENT) * per
    cuts = [cost(-(-pl.chunks // g))
            for g in range(2, tff.MAX_PREFILL_GROUPS + 1)]
    if groups > 1:
        assert 10 * cost(pl.per_group) <= 9 * cost(pl.chunks)
        assert cost(pl.per_group) == min(cuts)
    else:
        assert all(10 * c > 9 * cost(pl.chunks) for c in cuts)
    # one cluster at a time fills every wave: one group; a decode fills
    # the card with groups whatever the residency
    assert tff.plan(t, d, f, torch.bfloat16, N_SM, 1).groups == 1
    assert tff.plan(4, d, f, torch.bfloat16, N_SM, RESIDENT) == tff.plan(
        4, d, f, torch.bfloat16, N_SM, 1)


@pytest.mark.parametrize("resident", [0, -1])
def test_plan_refuses_a_card_with_no_resident_cluster(resident):
    """The bf16 plan reads the card's resident clusters (at least 1); the
    f32 plan does not."""
    with pytest.raises(ValueError, match="at least 1 resident cluster"):
        tff.plan(2048, *GLM4, torch.bfloat16, N_SM, resident)
    assert tff.plan(7, *GLM4, torch.float32, N_SM, resident) == tff.plan(
        7, *GLM4, torch.float32, N_SM, RESIDENT)


def test_plan_span_records_the_one_slice_launch(monkeypatch):
    """``launch_plan`` runs under the span ``ffn.plan``; with a profile on,
    ``trace.records()`` holds the plan's slices, groups, cluster, grid,
    columns per block and the resident clusters it planned for."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import trace

    class Props:
        multi_processor_count = N_SM
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    monkeypatch.setattr(tff, "resident_clusters",
                        lambda dev, t, d, f, n_sm: RESIDENT)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tff.launch_plan(1500, *GLM4, torch.bfloat16,
                              torch.device("cuda", 0))
    (rec,) = trace.records("ffn.plan")
    trace.clear()
    pl = tff.plan(1500, *GLM4, torch.bfloat16, N_SM, RESIDENT)
    assert got == (N_SM, RESIDENT, pl)
    assert rec.args == {"slices": 1, "groups": 3, "cluster": 8,
                        "grid": (8, 24, 3), "cols": 512,
                        "resident": RESIDENT}


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
        # past 3584 one cluster takes it at 256 columns a warpgroup (and a
        # d_model past 4096 in slices): only the CPU tensors are refused
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
    (3, 5120, 512, "silu", True), (2, 8192, 256, "gelu", False),
    # glm4-9b's width in one cluster of 8 x 512 columns, a ragged T
    (70, 4096, 1024, "silu", True), (130, 4096, 512, "silu", True)])
def test_tile_walk_emulation_matches_plain_version_and_jax(t, d, f, act,
                                                           gated):
    _check_emulation(t, d, f, act, gated, tff.plan(t, d, f, torch.bfloat16,
                                                   N_SM, RESIDENT))


def test_tile_walk_emulation_with_prefill_groups_matches():
    """A prefill whose clusters fill the card (10 token tiles at d 2048, 4
    resident) cut into 2 d_ff groups: their f32 partials summed in order."""
    pl = tff.plan(600, 2048, 2048, torch.bfloat16, N_SM, 4)
    assert (pl.groups, pl.per_group, pl.grid) == (2, 2, (8, 10, 2))
    _check_emulation(600, 2048, 2048, "silu", True, pl)


def _check_emulation(t, d, f, act, gated, pl):
    rng = np.random.default_rng(t + d + f)
    x = rng.standard_normal((t, d))
    ws = [rng.standard_normal(s) * min(0.05, s[0] ** -0.5)
          for s in ((d, f), (d, f), (f, d))]
    tx, tg, tu, td = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                      for a in (x, *ws))
    tg = tg if gated else None
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
