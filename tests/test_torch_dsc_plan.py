"""What the fused-DSC kernel is handed, checked on the CPU.

``repro_torch.kernels.fused_dsc.plan`` decides each launch: a
persistent grid of ``min(units, SMs x resident blocks)`` thread blocks, a
unit being (image, tile of ``tile_rows`` output rows), each block staging
the weights once (K-major, K padded to the int8 MMA depth) and walking its
units; the shared-memory layout of the strip buffers, F1 and F2. The CUDA
kernel runs only on a card (``tests/test_torch_kernels.py``, ``-m gpu``,
and ``chip_smoke.py``); its launcher takes this plan's numbers or refuses
them. Here the plan's coverage and sizes, the wrapper's refusals, and a
plain torch emulation of the kernel's tile walk (against the plain version
and the JAX package) are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_dsc import fused_dsc_pallas
from repro_torch.core import dsc as tdsc
from repro_torch.core.dsc import DSCBlockSpec as S
from repro_torch.kernels import fused_dsc as tfd
from repro_torch.kernels import ref

N_SM = 132   # an H100 SXM
# The seven blocks of the 80x80 MobileNetV2-VWW network: (name, spec, map)
VWW = [("3rd", S(8, 48, 8, 1), 40), ("b2", S(8, 48, 16, 2), 40),
       ("5th", S(16, 96, 16, 1), 20), ("b4", S(16, 96, 24, 2), 20),
       ("8th", S(24, 144, 24, 1), 10), ("b6", S(24, 144, 56, 2), 10),
       ("15th", S(56, 336, 56, 1), 5)]
# tests/test_kernels.py's fused-DSC matrix: (spec, map, tile_rows)
RAGGED = [(S(8, 48, 8, 1), 12, 4), (S(8, 48, 16, 2), 12, 3),
          (S(16, 96, 16, 1), 10, 2), (S(8, 24, 8, 1), 9, 5),
          (S(8, 24, 8, 1), 13, 4), (S(8, 24, 16, 2), 13, 4),
          (S(8, 24, 8, 2), 11, 4), (S(8, 24, 8, 1), 7, 16)]
# (batch, spec, map, tile_rows) for every plan the tests hold
PLANS = ([(b, spec, hw, None) for b in (1, 64, 256) for _, spec, hw in VWW]
         + [(b, spec, hw, t) for b in (1, 64, 256) for _, spec, hw in VWW
            for t in (1, 3)]
         + [(4, spec, hw, t) for spec, hw, t in RAGGED]
         + [(4, spec, hw, None) for spec, hw, _ in RAGGED])


def _ids(cases):
    return [f"B{b}-{s.cin}x{s.cmid}x{s.cout}s{s.stride}@{hw}-t{t}"
            for b, s, hw, t in cases]


def _plan(batch, spec, hw, tile_rows):
    return tfd.plan(batch, hw, hw, spec.cin, spec.cmid, spec.cout,
                    spec.stride, tile_rows, N_SM)


@pytest.mark.parametrize("batch,spec,hw,tile_rows", PLANS, ids=_ids(PLANS))
def test_plan_covers_every_output_row_of_every_image_once(batch, spec, hw,
                                                          tile_rows):
    pl = _plan(batch, spec, hw, tile_rows)
    h2 = -(-hw // spec.stride)
    want_t = h2 if tile_rows is None else min(tile_rows, h2)
    assert 1 <= pl.tile_rows <= want_t
    assert pl.n_tiles == -(-h2 // pl.tile_rows)
    assert pl.units == batch * pl.n_tiles
    assert 1 <= pl.grid <= min(pl.units, N_SM * pl.blocks_per_sm)
    seen = np.zeros((batch, h2), np.int64)
    walked = []
    for block in range(pl.grid):
        for u in pl.units_of_block(block):
            img, row0 = pl.unit(u)
            seen[img, row0:min(h2, row0 + pl.tile_rows)] += 1
            walked.append(u)
    assert (seen == 1).all()
    assert sorted(walked) == list(range(pl.units))
    # the persistent blocks share the units within one unit of each other
    per_block = [len(list(pl.units_of_block(b))) for b in range(pl.grid)]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("batch,spec,hw,tile_rows", PLANS, ids=_ids(PLANS))
def test_plan_fits_shared_memory_and_pads_k_to_the_mma_depth(batch, spec, hw,
                                                            tile_rows):
    pl = _plan(batch, spec, hw, tile_rows)
    assert pl.smem_bytes <= 227 * 1024
    assert 1 <= pl.blocks_per_sm <= tfd.MAX_BLOCKS_PER_SM
    assert pl.blocks_per_sm * (pl.smem_bytes + tfd.SMEM_RESERVED) \
        <= tfd.SMEM_PER_SM
    assert pl.smem_bytes % 16 == 0
    for k, c in ((pl.kx, spec.cin), (pl.kp, spec.cmid)):
        assert k % tfd.MMA_K == 0 and c <= k < c + tfd.MMA_K
    # fragment rows 16 bytes modulo 32 apart: eight rows, distinct banks
    for k, stride in ((pl.kx, pl.kxs), (pl.kp, pl.kps)):
        assert stride >= k and stride % 32 == 16
        banks = {(r * stride // 4 + w) % 32 for r in range(8) for w in range(4)}
        assert len(banks) == 32
    w2 = -(-hw // spec.stride)
    assert pl.runs * tfd.RUN >= w2 > (pl.runs - 1) * tfd.RUN
    assert pl.wf1 >= max(hw + 2, spec.stride * (pl.runs * tfd.RUN - 1) + 3)


def test_batch_one_spreads_over_more_blocks_than_four_row_tiles():
    # one block per 4-row tile would give 2-10 blocks at batch 1
    for _, spec, hw in VWW:
        h2 = -(-hw // spec.stride)
        pl = _plan(1, spec, hw, None)
        assert pl.grid == h2 > -(-h2 // 4)


def test_vww_plans_are_pinned():
    got = {(b, name): _plan(b, spec, hw, None).tile_rows
           for b in (1, 64, 256) for name, spec, hw in VWW}
    assert [got[1, n] for n, *_ in VWW] == [1] * 7
    assert [got[64, n] for n, *_ in VWW] == [10, 5, 5, 3, 3, 2, 2]
    assert [got[256, n] for n, *_ in VWW] == [20, 10, 20, 10, 10, 5, 5]
    pl = _plan(256, VWW[0][1], 40, None)
    assert (pl.units, pl.grid, pl.blocks_per_sm, pl.smem_bytes) == (
        512, 264, 2, 112560)


@pytest.mark.parametrize("widths,match", [
    ((12, 48, 8), "multiples of 8"), ((8, 44, 8), "multiples of 8"),
    ((72, 48, 8), "C <= 64"), ((8, 1032, 8), "M <= 1024")])
def test_plan_refuses_widths_the_kernel_does_not_take(widths, match):
    with pytest.raises(ValueError, match=match):
        tfd.plan(1, 8, 8, *widths, 1)


def test_plan_refuses_a_map_too_wide_for_shared_memory_and_names_it():
    with pytest.raises(ValueError, match=r"C 64, M 1024, N 64, stride 1 on a "
                                         r"200x200 map"):
        tfd.plan(1, 200, 200, 64, 1024, 64, 1)
    with pytest.raises(ValueError, match="no tile of 40 rows fits"):
        tfd.plan(1, 200, 200, 64, 1024, 64, 1, tile_rows=40)


# ---------------------------------------------------------------------------
# the wrapper's refusals: each raises before any launch
# ---------------------------------------------------------------------------


def _block(spec=S(8, 48, 8, 1), hw=6, batch=2):
    rng = np.random.default_rng(3)
    p32 = tdsc.init_dsc_block_f32(rng, spec)
    calib = rng.standard_normal((hw, hw, spec.cin)).astype(np.float32)
    qp = tdsc.quantize_dsc_block(p32, spec, calib)
    x = torch.from_numpy(rng.integers(-128, 128, (batch, hw, hw, spec.cin),
                                      dtype=np.int8))
    args = [x, qp.w_exp, qp.w_dw.reshape(9, spec.cmid), qp.w_proj, qp.b_exp,
            qp.b_dw, qp.b_proj, qp.m_exp, qp.m_dw, qp.m_proj]
    statics = dict(stride=spec.stride, zps=qp.zps, q6=(qp.q6_f1, qp.q6_f2))
    return [a.contiguous() for a in args], statics


def _refusal(case):
    args, st = _block()
    err, msg, kw = ValueError, None, {}
    if case == "cpu":
        msg = "CUDA tensors"
    elif case == "x 3-d":
        args[0], msg = args[0][0], r"\(B, H, W, C\)"
    elif case == "x int16":
        args[0] = args[0].to(torch.int16)
        err, msg = TypeError, "x_q has dtype"
    elif case == "m_exp float64":
        args[7] = args[7].double()
        err, msg = TypeError, "m_exp has dtype"
    elif case == "w_dw9 shape":
        args[2], msg = args[2].reshape(3, 3, -1), "w_dw9 has shape"
    elif case == "b_proj shape":
        args[6], msg = args[6][:4].clone(), "b_proj has shape"
    elif case == "stride 3":
        st["stride"], msg = 3, "stride must be 1 or 2"
    elif case == "tile_rows 0":
        kw, msg = {"tile_rows": 0}, "tile_rows must be >= 1"
    elif case == "non-contiguous":
        args[0] = args[0].transpose(1, 2)
        msg = "x_q must be contiguous"
    elif case == "misaligned":
        n = args[1].numel()
        args[1] = torch.zeros(n + 1, dtype=torch.int8)[1:].view(args[1].shape)
        msg = "16-byte boundaries"
    elif case == "widths":
        args, st = _block(S(12, 48, 8, 1))
        msg = "multiples of 8"
    return args, st, kw, err, msg


@pytest.mark.parametrize("case", [
    "cpu", "x 3-d", "x int16", "m_exp float64", "w_dw9 shape", "b_proj shape",
    "stride 3", "tile_rows 0", "non-contiguous", "misaligned", "widths"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, st, kw, err, msg = _refusal(case)
    before = tfd.LAUNCHES
    with pytest.raises(err, match=msg):
        tfd.fused_dsc_cuda(*args, **st, **kw)
    assert tfd.LAUNCHES == before


# ---------------------------------------------------------------------------
# the kernel's tile walk, emulated in plain torch
# ---------------------------------------------------------------------------


def _requant(acc, m, zp, lo, hi):
    y = torch.round(acc.to(torch.float32) * m).to(torch.int64) + zp
    return torch.clamp(y, lo, hi)


def _emulate(x, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj, m_exp, m_dw,
             m_proj, *, stride, zps, q6, pl, seed=0):
    """The kernel's arithmetic, unit by unit, with its shared-memory shapes:
    for each tile (all images at once) the haloed input strip in (pixel,
    kx) rows, its bytes past C and its out-of-map rows holding junk; the
    expansion against w_exp^T zero-padded to kx; F1 in (strip, wf1, M) with
    out-of-map rows set to zp_f1 after the expansion and the halo columns
    zp_f1; the depthwise over 4-channel groups and runs of RUN columns
    (columns past W2 computed and dropped); F2 in (pixel, kp) rows with
    junk past M; the projection against w_proj^T zero-padded to kp."""
    gen = torch.Generator().manual_seed(seed)
    junk = lambda *shape: torch.randint(-128, 128, shape, generator=gen)
    s = stride
    b, h, w, c = x.shape
    m, n = w_exp.shape[1], w_proj.shape[1]
    h2, w2 = -(-h // s), -(-w // s)
    _, zp1, zp2, zpo = zps
    q61, q62 = min(q6[0], 127), min(q6[1], 127)
    wexp_t = torch.zeros(m, pl.kx, dtype=torch.int64)
    wexp_t[:, :c] = w_exp.T.long()
    wproj_t = torch.zeros(n, pl.kp, dtype=torch.int64)
    wproj_t[:, :m] = w_proj.T.long()
    taps = w_dw9.long().reshape(9, m // 4, 4)
    out = torch.empty(b, h2, w2, n, dtype=torch.int64)
    for tile in range(pl.n_tiles):
        row0 = tile * pl.tile_rows
        rows = min(pl.tile_rows, h2 - row0)
        strip = (rows - 1) * s + 3
        r0 = row0 * s - 1
        in_map = [0 <= r0 + r < h for r in range(strip)]
        xs = junk(b, strip, w, pl.kx)
        for r in range(strip):
            if in_map[r]:
                xs[:, r, :, :c] = x[:, r0 + r].long()
        acc = xs.reshape(b, strip * w, pl.kx) @ wexp_t.T + b_exp.long()
        f1 = _requant(acc, m_exp, zp1, zp1, q61).reshape(b, strip, w, m)
        f1[:, [not ok for ok in in_map]] = zp1
        f1s = torch.full((b, strip, pl.wf1, m), zp1, dtype=torch.int64)
        f1s[:, :, 1:w + 1] = f1
        f1g = f1s.reshape(b, strip, pl.wf1, m // 4, 4)
        cols = pl.runs * tfd.RUN
        acc2 = b_dw.long().reshape(m // 4, 4).expand(b, rows, cols, m // 4,
                                                     4).clone()
        for dy in range(3):
            for dx in range(3):
                win = f1g[:, dy:dy + (rows - 1) * s + 1:s,
                          dx:dx + (cols - 1) * s + 1:s]
                acc2 += win * taps[dy * 3 + dx]
        f2 = _requant(acc2.reshape(b, rows, cols, m), m_dw, zp2, zp2, q62)
        f2s = junk(b, rows * w2, pl.kp)
        f2s[:, :, :m] = f2[:, :, :w2].reshape(b, rows * w2, m)
        acc3 = f2s @ wproj_t.T + b_proj.long()
        y = _requant(acc3, m_proj, zpo, -128, 127)
        out[:, row0:row0 + rows] = y.reshape(b, rows, w2, n)
    return out.to(torch.int8)


def _jax_ref(x, args, st):
    f = jax.vmap(lambda xi: jref.fused_dsc_ref(xi, *args, **st))
    return np.asarray(f(jnp.asarray(x.numpy())))


def _case(spec, hw, batch, seed, b_exp=None):
    rng = np.random.default_rng(seed)
    p32 = tdsc.init_dsc_block_f32(rng, spec)
    if b_exp is not None:
        p32["b_exp"] = torch.from_numpy(b_exp)
    calib = rng.standard_normal((hw, hw, spec.cin)).astype(np.float32)
    qp = tdsc.quantize_dsc_block(p32, spec, calib)
    x = torch.from_numpy(rng.integers(-128, 128, (batch, hw, hw, spec.cin),
                                      dtype=np.int8))
    ts = [qp.w_exp, qp.w_dw.reshape(9, spec.cmid), qp.w_proj, qp.b_exp,
          qp.b_dw, qp.b_proj, qp.m_exp, qp.m_dw, qp.m_proj]
    st = dict(stride=spec.stride, zps=qp.zps, q6=(qp.q6_f1, qp.q6_f2))
    return x, ts, st


# The tile heights the plans pick for the VWW blocks at batch 1, 64 and
# 256, run on two images: a unit's arithmetic does not depend on the batch,
# only which block walks it does (held by the coverage test above).
WALKS = sorted({(name, spec, hw, _plan(b, spec, hw, None).tile_rows)
                for b in (1, 64, 256) for name, spec, hw in VWW},
               key=lambda c: ([n for n, *_ in VWW].index(c[0]), c[3]))


@pytest.mark.parametrize("name,spec,hw,tile_rows", WALKS,
                         ids=[f"{c[0]}-t{c[3]}" for c in WALKS])
def test_tile_walk_emulation_matches_plain_and_jax_on_vww_blocks(
        name, spec, hw, tile_rows):
    x, ts, st = _case(spec, hw, 2, seed=hw + spec.cmid)
    pl = _plan(2, spec, hw, tile_rows)
    got = _emulate(x, *ts, **st, pl=pl)
    want = ref.fused_dsc_ref(x, *ts, **st)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), _jax_ref(x, [t.numpy() for t in ts], st))


@pytest.mark.parametrize("spec,hw,tile_rows", RAGGED)
@pytest.mark.parametrize("explicit", [True, False])
def test_tile_walk_emulation_matches_plain_jax_and_pallas_on_ragged_shapes(
        spec, hw, tile_rows, explicit):
    x, ts, st = _case(spec, hw, 2, seed=hw * 7 + spec.cmid)
    pl = _plan(2, spec, hw, tile_rows if explicit else None)
    got = _emulate(x, *ts, **st, pl=pl)
    assert torch.equal(got, ref.fused_dsc_ref(x, *ts, **st))
    arrays = [t.numpy() for t in ts]
    np.testing.assert_array_equal(got.numpy(), _jax_ref(x, arrays, st))
    if not explicit:   # the same Pallas launch as the explicit case
        return
    pallas = fused_dsc_pallas(jnp.asarray(x[0].numpy()), *arrays,
                              tile_rows=tile_rows, interpret=True, **st)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pallas))


def test_tile_walk_emulation_with_nonzero_expansion_bias_matches_oracle():
    # Held to the plain version and the JAX oracle only: the Pallas kernel
    # pads x rows, not F1, and differs from its own oracle here (ROADMAP,
    # Caveats).
    spec, hw = S(8, 24, 8, 1), 9
    b = np.random.default_rng(7).standard_normal(spec.cmid).astype(np.float32)
    x, ts, st = _case(spec, hw, 3, seed=5, b_exp=b)
    for tile_rows in (None, 2, 4):
        got = _emulate(x, *ts, **st, pl=_plan(3, spec, hw, tile_rows))
        assert torch.equal(got, ref.fused_dsc_ref(x, *ts, **st))
        np.testing.assert_array_equal(
            got.numpy(), _jax_ref(x, [t.numpy() for t in ts], st))
