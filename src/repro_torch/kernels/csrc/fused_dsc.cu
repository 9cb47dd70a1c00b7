// Fused int8 Expansion -> Depthwise -> Projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_dsc.py::
// _fused_dsc_kernel (launched by fused_dsc_pallas). It computes exactly what
// the plain version src/repro_torch/kernels/ref.py::fused_dsc_ref computes,
// bit for bit: one inverted-residual block (without the residual add) over a
// batch of NHWC int8 maps:
//   F1 = relu6q(requant(x . w_exp + b_exp)), out-of-map F1 = zp_f1;
//   F2 = relu6q(requant(dw3x3_s(F1) + b_dw));
//   y  = requant(F2 . w_proj + b_proj), clamped to [-128, 127].
// F1 and F2 live in shared memory and registers; device memory sees only
// the input, the weights and the output.
//
// Bound on this card (H100 SXM: 1,979 TOP/s int8 dense, 3.35 TB/s HBM). At
// the MobileNetV2-VWW shapes (80x80 input, seven blocks, C 8-56, M 48-336,
// N 8-56) every block is bound by bytes: the seven at batch 256 move ~20 MB,
// ~6 us. What the card spends instead is issue slots and their latency: the
// two 1x1 products (~1.6 G MACs at batch 256) and the depthwise (~0.4 G
// MACs), plus ~110 M requantized elements, spread over small per-image
// tiles with a barrier between the three phases.
//
// Design.
//   - A persistent grid: min(units, resident blocks) blocks walk the units,
//     one unit being (image, tile of `tile_rows` output rows). Each block
//     stages the weights once, transposed and zero-padded into the layouts
//     the MMAs read (K-major B operands, K = C or M padded to 16), and then
//     walks its units. The next unit's haloed input strip arrives by
//     cp.async (8 or 16 bytes a copy) while the block computes the current
//     one; rows outside the map are not copied, as their F1 is zp_f1.
//   - Both 1x1 products on the int8 tensor cores:
//     mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32. Expansion: rows =
//     strip pixels, K = C, N = M; its K steps are a template parameter, so
//     no MMA slot is predicated off. Projection: rows = output pixels, K =
//     M, N = cout, two n-tiles at a time. The sums are exact in int32
//     (|acc| <= 336 * 128^2 < 2^31), so they equal the scalar sums bit for
//     bit. Fragments are plain 32-bit shared loads; every row stride that a
//     fragment load walks is 16 bytes modulo 32, so the eight rows of a
//     fragment fall on distinct banks.
//   - The expansion's epilogue has no branch: rows past the strip or
//     outside the map are stored to one trash pixel, and a separate loop
//     writes zp_f1 over the out-of-map rows (the first and last tiles of an
//     image), as the oracle pads F1 after the expansion.
//   - The requantization runs on the accumulator fragments:
//     round(float32(acc + b) * m) with round-half-to-even, as jnp.round and
//     torch.round do: __int2float_rn, __fmul_rn (no FMA contraction) and
//     __float2int_rn. Never roundf, which rounds half away from zero.
//   - The depthwise is vectorised over channels: a thread owns 4 channels
//     (one 32-bit shared load per F1 pixel) and a run of kRun output
//     columns, keeps the 9 taps of its channels in registers for the whole
//     launch, and loads each F1 column of its run once for the outputs that
//     share it. A 4 x 4 byte transpose turns 4 columns x 4 channels into 4
//     columns of one channel, so one dp4a sums the three taps of a row
//     (weights (w0, w1, w2, 0)); a funnel shift slides the window. The
//     stride is a template parameter, so every index in the inner loops is
//     a compile-time constant.
//
// Interface: plain C, loaded with ctypes. The launcher takes device
// pointers, ints and a stream; launches on that stream, does not
// synchronise, allocates nothing and returns cudaGetLastError(). It takes
// the launch plan of kernels/fused_dsc.py::plan (tile height, units, grid,
// shared-memory layout) as its numbers and decides nothing itself: it
// refuses a plan whose layout differs from the kernel's own map at that tile
// height, whose tiles or units do not cover the batch, or whose grid is
// empty or larger than its units.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;   // __launch_bounds__: <= 128 registers
constexpr int kRun = 5;              // output columns per depthwise item
constexpr int kTaps = 9;
constexpr int kMmaK = 16;            // m16n8k16: K bytes per product
constexpr int kMaxKSteps = 4;        // expansion K (C padded) up to 64
constexpr int kMaxMid = 4 * kThreads;   // one 4-channel group per thread
constexpr long long kSmemLimit = 232448;   // 227 KB per block (opt-in)

constexpr int kBadArgs = -2;   // widths or stride the kernel does not take
constexpr int kBadPlan = -3;   // a handed plan the kernel cannot run
const char* g_refusal = "";    // which check refused the plan

// ---- the shared-memory layout, and the check of a handed plan --------------

struct Layout {
  long long smem, kx, kp, kxs, kps, wf1, runs;
  // byte offsets of the shared-memory regions
  long long off_wproj, off_params, off_x, x_bytes, off_f1, off_f2;
};

long long round16(long long v) { return (v + 15) / 16 * 16; }

// A row stride, in bytes, for K-major int8 rows of k (a multiple of 16)
// bytes: 16 modulo 32, so the 8 rows of an mma fragment (4 words each) fall
// on distinct banks.
long long pad_stride(long long k) { return k % 32 == 0 ? k + 16 : k; }

// The layout of one block for tiles of t output rows.
void layout(int w, int cin, int cmid, int cout, int s, int t, Layout* ly) {
  const long long w2 = (w + s - 1) / s;
  ly->kx = round16(cin);
  ly->kp = round16(cmid);
  ly->kxs = pad_stride(ly->kx);
  ly->kps = pad_stride(ly->kp);
  ly->runs = (w2 + kRun - 1) / kRun;
  const long long reach = static_cast<long long>(s) * (ly->runs * kRun - 1)
                        + 3;
  ly->wf1 = reach > w + 2 ? reach : w + 2;
  const long long strip = static_cast<long long>(t - 1) * s + 3;
  const long long x_rows = round16(strip * w);
  const long long f2_rows = round16(static_cast<long long>(t) * w2);
  long long off = round16(static_cast<long long>(cmid) * ly->kxs);  // w_exp^T
  ly->off_wproj = off;
  off += round16(static_cast<long long>(cout) * ly->kps);           // w_proj^T
  ly->off_params = off;
  off += round16(4LL * (2 * cmid + 2 * cout));   // b_exp, m_exp, b_proj, m_proj
  ly->off_x = off;
  ly->x_bytes = round16(x_rows * ly->kxs);
  off += 2 * ly->x_bytes;                        // two strip buffers
  ly->off_f1 = off;
  off += round16((strip * ly->wf1 + 1) * cmid);  // F1 strip, a trash pixel
  ly->off_f2 = off;
  off += round16(f2_rows * ly->kps);             // F2 tile
  ly->smem = off;
}

int refuse(const char* why) {
  g_refusal = why;
  return kBadPlan;
}

// 0 if the kernel runs the handed plan (tile_rows, n_tiles, units,
// blocks_per_sm, grid, smem, kx, kp, kxs, kps, wf1, runs) of a batch of
// (h, w, cin) maps, filling `ly` with its layout; else kBadArgs or
// kBadPlan, with g_refusal naming the check. blocks_per_sm is what the
// grid assumes of the card (fused_dsc_occupancy asks it); no launch reads
// it.
int check_plan(int batch, int h, int w, int cin, int cmid, int cout, int s,
               const int* plan, Layout* ly) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cmid <= 0 || cout <= 0 ||
      (s != 1 && s != 2) || cin % 8 || cmid % 8 || cout % 8 ||
      cin > kMmaK * kMaxKSteps || cmid > kMaxMid)
    return kBadArgs;
  const int t = plan[0], n_tiles = plan[1], units = plan[2], grid = plan[4];
  const long long h2 = (h + s - 1) / s;
  if (t < 1 || t > h2)
    return refuse("tile_rows outside [1, ceil(H / stride)]");
  layout(w, cin, cmid, cout, s, t, ly);
  const long long own[7] = {ly->smem, ly->kx, ly->kp, ly->kxs, ly->kps,
                            ly->wf1, ly->runs};
  for (int i = 0; i < 7; ++i)
    if (plan[5 + i] != own[i])
      return refuse("smem, kx, kp, kxs, kps, wf1 or runs differ from the "
                    "kernel's layout at tile_rows");
  if (ly->smem > kSmemLimit)
    return refuse("smem above the 232448 bytes a block may opt in to");
  if (n_tiles != (h2 + t - 1) / t)
    return refuse("n_tiles != ceil(H2 / tile_rows): the tiles do not cover "
                  "the output rows");
  if (units != static_cast<long long>(batch) * n_tiles)
    return refuse("units != batch * n_tiles");
  if (grid < 1 || grid > units) return refuse("grid outside [1, units]");
  return 0;
}

// ---- device helpers --------------------------------------------------------

struct Params {
  const int8_t* x;
  const int8_t* w_exp;   // (C, M)
  const int8_t* w_dw9;   // (9, M), tap-major
  const int8_t* w_proj;  // (M, N)
  const int32_t* b_exp;
  const int32_t* b_dw;
  const int32_t* b_proj;
  const float* m_exp;
  const float* m_dw;
  const float* m_proj;
  int8_t* out;           // (B, H2, W2, N)
  int h, w, cin, cmid, cout, h2, w2;
  int tile_rows, n_tiles, units;
  int kx, kp, kxs, kps, wf1, runs;
  int off_wproj, off_params, off_x, x_bytes, off_f1, off_f2;
  int f1_trash;          // F1 offset of the pixel that takes discarded rows
  int zp_f1, zp_f2, zp_out, q6_f1, q6_f2;
};

__device__ __forceinline__ int requant(int acc, float m, int zp, int lo,
                                       int hi) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(acc), m)) + zp;
  return min(max(q, lo), hi);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st16(int8_t* p, int lo, int hi) {
  *reinterpret_cast<uint16_t*>(p) =
      static_cast<uint16_t>((lo & 0xff) | ((hi & 0xff) << 8));
}

// D (16 x 8, s32) += A (16 x 16, s8, row) . B (16 x 8, s8, col).
// A: a0 rows g, a1 rows g + 8, bytes 4 * (lane % 4) .. + 3 of K;
// B: column g, the same 4 bytes of K; D: rows g and g + 8, columns
// 2 * (lane % 4) and + 1 (g = lane / 4).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void cp_async8(int8_t* dst, const int8_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where unit u's tile lies: image, first output row, valid rows.
struct Unit {
  int img, row0, rows;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit t;
  t.img = u / p.n_tiles;
  t.row0 = (u - t.img * p.n_tiles) * p.tile_rows;
  t.rows = min(p.tile_rows, p.h2 - t.row0);
  return t;
}

// Start copying unit u's input strip, the x rows (rows - 1) * S + 3 from
// row0 * S - 1, into `dst` as (pixel, kxs) rows; rows outside the map are
// skipped. Strip rows are consecutive in x, so the copy is one run.
template <int S>
__device__ __forceinline__ void issue_strip(const Params& p, int u,
                                            int8_t* dst) {
  const Unit t = unit_of(p, u);
  const int r0 = t.row0 * S - 1;
  const int ra = max(0, -r0);                               // first in map
  const int rb = min((t.rows - 1) * S + 3, p.h - r0);       // past the last
  if (rb <= ra) return;
  const int8_t* src = p.x
      + (static_cast<size_t>(t.img) * p.h + r0 + ra) * p.w * p.cin;
  int8_t* base = dst + ra * p.w * p.kxs;
  const int pixels = (rb - ra) * p.w;
  if (p.cin % 16 == 0) {
    const int per = p.cin / 16;
    for (int i = threadIdx.x; i < pixels * per; i += kThreads) {
      const int px = i / per, part = i - px * per;
      cp_async16(base + px * p.kxs + part * 16, src + i * 16);
    }
  } else {
    const int per = p.cin / 8;
    for (int i = threadIdx.x; i < pixels * per; i += kThreads) {
      const int px = i / per, part = i - px * per;
      cp_async8(base + px * p.kxs + part * 8, src + i * 8);
    }
  }
}

// Stage a row-major (rows, cols) int8 matrix from device memory as its
// transpose: dst[c * stride + k] = src[k * cols + c] for k < rows, 0 for
// rows <= k < kpad. A thread takes 4 rows x 8 columns: four 8-byte loads,
// byte permutes, eight 32-bit stores; it walks the columns rotated by its
// column block so that the stores of a warp spread over the banks.
__device__ __forceinline__ void stage_transposed(const int8_t* src, int rows,
                                                 int cols, int kpad,
                                                 int stride, int8_t* dst) {
  const int kwords = kpad / 4, blocks = cols / 8;
  uint32_t* out = reinterpret_cast<uint32_t*>(dst);
  const int out_stride = stride / 4;
  for (int i = threadIdx.x; i < kwords * blocks; i += kThreads) {
    const int kw = i % kwords, nb = i / kwords;
    uint2 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kw + j;
      r[j] = k < rows ? __ldg(reinterpret_cast<const uint2*>(
                            src + static_cast<size_t>(k) * cols) + nb)
                      : make_uint2(0, 0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j + nb) & 7;
      const int b = c & 3;
      const uint32_t sel = b | ((b + 4) << 4);
      const uint32_t lo = __byte_perm(c < 4 ? r[0].x : r[0].y,
                                      c < 4 ? r[1].x : r[1].y, sel);
      const uint32_t hi = __byte_perm(c < 4 ? r[2].x : r[2].y,
                                      c < 4 ? r[3].x : r[3].y, sel);
      out[(8 * nb + c) * out_stride + kw] = __byte_perm(lo, hi, 0x5410);
    }
  }
}

// ---- the kernel ------------------------------------------------------------

// S: the depthwise stride; KS: the expansion's K in steps of kMmaK (C
// padded to 16, 32, 48 or 64).
template <int S, int KS>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
fused_dsc_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* s_wexp = smem;                               // (M, kxs)
  int8_t* s_wproj = smem + p.off_wproj;                // (N, kps)
  int32_t* s_bexp = reinterpret_cast<int32_t*>(smem + p.off_params);
  float* s_mexp = reinterpret_cast<float*>(s_bexp + p.cmid);
  int32_t* s_bproj = reinterpret_cast<int32_t*>(s_mexp + p.cmid);
  float* s_mproj = reinterpret_cast<float*>(s_bproj + p.cout);
  int8_t* s_x = smem + p.off_x;                        // 2 x (pixels, kxs)
  int8_t* s_f1 = smem + p.off_f1;                // (strip, wf1, M) + trash
  int8_t* s_f2 = smem + p.off_f2;                      // (pixels, kps)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int cmid = p.cmid, cout = p.cout;
  const int groups = cmid / 4;                         // 4-channel groups
  const uint32_t zp4_f1 = (p.zp_f1 & 0xff) * 0x01010101u;

  // The first unit's strip is in flight while the weights are staged.
  issue_strip<S>(p, blockIdx.x, s_x);
  cp_async_commit();

  // ---- weights, once per block: transposed, K zero-padded ----------------
  stage_transposed(p.w_exp, p.cin, cmid, p.kx, p.kxs, s_wexp);
  stage_transposed(p.w_proj, cmid, cout, p.kp, p.kps, s_wproj);
  for (int i = tid; i < cmid; i += kThreads) {
    s_bexp[i] = __ldg(p.b_exp + i);
    s_mexp[i] = __ldg(p.m_exp + i);
  }
  for (int i = tid; i < cout; i += kThreads) {
    s_bproj[i] = __ldg(p.b_proj + i);
    s_mproj[i] = __ldg(p.m_proj + i);
  }
  // F1's halo columns (0, and W + 1 up to the run slack) hold zp_f1 for
  // every unit: the expansion writes only columns 1..W.
  {
    const int strip_max = (p.tile_rows - 1) * S + 3;
    const int halo_cols = p.wf1 - p.w;
    uint32_t* f1w = reinterpret_cast<uint32_t*>(s_f1);
    for (int i = tid; i < strip_max * halo_cols * groups; i += kThreads) {
      const int grp = i % groups;
      const int rc = i / groups;
      const int r = rc / halo_cols, hc = rc - r * halo_cols;
      const int c = hc == 0 ? 0 : p.w + hc;
      f1w[(r * p.wf1 + c) * groups + grp] = zp4_f1;
    }
  }

  // The depthwise thread's channel group and its taps, biases and
  // multipliers, in registers for the whole launch: wrow[ch][dy] holds
  // (w[dy][0], w[dy][1], w[dy][2], 0) of channel 4 * cg + ch.
  const int dw_pos = tid / groups, dw_npos = kThreads / groups;
  const int cg = tid - dw_pos * groups;
  const bool dw_active = dw_pos < dw_npos;
  uint32_t wrow[4][3];
  int bdw[4];
  float mdw[4];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    uint32_t wq[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      wq[dx] = dw_active ? __ldg(reinterpret_cast<const uint32_t*>(
                               p.w_dw9 + (dy * 3 + dx) * cmid) + cg)
                         : 0u;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const uint32_t ab = __byte_perm(wq[0], wq[1], ch | ((4 + ch) << 4));
      wrow[ch][dy] =
          __byte_perm(ab, wq[2], 0x0010 | ((4 + ch) << 8)) & 0x00ffffffu;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    bdw[c] = dw_active ? __ldg(p.b_dw + 4 * cg + c) : 0;
    mdw[c] = dw_active ? __ldg(p.m_dw + 4 * cg + c) : 0.f;
  }

  int buf = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, buf ^= 1) {
    if (u + static_cast<int>(gridDim.x) < p.units)
      issue_strip<S>(p, u + gridDim.x, s_x + (buf ^ 1) * p.x_bytes);
    cp_async_commit();
    cp_async_wait_prev();   // this unit's strip has landed
    __syncthreads();

    const Unit t = unit_of(p, u);
    const int r0 = t.row0 * S - 1;
    const int strip = (t.rows - 1) * S + 3;

    // ---- Expansion: F1 = requant(x . w_exp + b_exp) on the tensor cores --
    {
      const int8_t* xs = s_x + buf * p.x_bytes;
      const int pixels = strip * p.w;
      const int mtiles = (pixels + 15) / 16;
      const int ntiles = cmid / 8;
      const int split = max(1, min(ntiles, kWarps / mtiles));
      const int per = (ntiles + split - 1) / split;
      for (int item = warp; item < mtiles * split; item += kWarps) {
        const int mt = item / split;
        const int nt0 = (item - mt * split) * per;
        const int nt1 = min(ntiles, nt0 + per);
        const int pa = mt * 16 + g, pb = pa + 8;
        uint32_t a[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          a[ks][0] = ld32(xs + pa * p.kxs + ks * kMmaK + t4 * 4);
          a[ks][1] = ld32(xs + pb * p.kxs + ks * kMmaK + t4 * 4);
        }
        // F1 byte offsets of the two rows; a row past the strip or outside
        // the map goes to the trash pixel (the fill below writes zp_f1 to
        // the out-of-map rows), so the stores need no branch.
        int fo[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = half ? pb : pa;
          const int r = px / p.w, c = px - r * p.w;
          fo[half] = px < pixels && r0 + r >= 0 && r0 + r < p.h
                         ? (r * p.wf1 + c + 1) * cmid
                         : p.f1_trash;
        }
        for (int nt = nt0; nt < nt1; ++nt) {
          int d[4] = {0, 0, 0, 0};
          const int8_t* wrow = s_wexp + (nt * 8 + g) * p.kxs + t4 * 4;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_s8(d, a[ks][0], a[ks][1], ld32(wrow + ks * kMmaK));
          const int m = nt * 8 + t4 * 2;
          const int2 b = *reinterpret_cast<const int2*>(s_bexp + m);
          const float2 mm = *reinterpret_cast<const float2*>(s_mexp + m);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            st16(s_f1 + fo[half] + m,
                 requant(d[2 * half] + b.x, mm.x, p.zp_f1, p.zp_f1, p.q6_f1),
                 requant(d[2 * half + 1] + b.y, mm.y, p.zp_f1, p.zp_f1,
                         p.q6_f1));
        }
      }
      // F1 = zp_f1 on the strip rows outside the map, columns 1..W: the
      // halo rows of the first and last tiles of an image.
      const int top = max(0, -r0);                       // rows [0, top)
      const int bottom = max(0, r0 + strip - p.h);       // the last ones
      const int row_words = p.w * groups;
      uint32_t* f1w = reinterpret_cast<uint32_t*>(s_f1);
      for (int i = tid; i < (top + bottom) * row_words; i += kThreads) {
        const int k = i / row_words, rest = i - k * row_words;
        const int r = k < top ? k : strip - bottom + (k - top);
        f1w[(r * p.wf1 + 1) * groups + rest] = zp4_f1;
      }
    }
    __syncthreads();

    // ---- Depthwise: F2 = requant(dw3x3_s(F1) + b_dw), 4 channels a thread
    if (dw_active) {
      constexpr int kCols = S * (kRun - 1) + 3;      // F1 columns of a run
      constexpr int kQuads = (kCols + 4) / 4;        // 4-column words
      const uint32_t* f1w = reinterpret_cast<const uint32_t*>(s_f1);
      uint32_t* f2w = reinterpret_cast<uint32_t*>(s_f2);
      const int row_words = p.wf1 * groups;
      const int f2_words = p.kps / 4;
      const int items = t.rows * p.runs;
      for (int it = dw_pos; it < items; it += dw_npos) {
        const int tr = it / p.runs;
        const int c0 = (it - tr * p.runs) * kRun;
        const uint32_t* src = f1w + (tr * S * p.wf1 + c0 * S) * groups + cg;
        int acc[kRun][4];
#pragma unroll
        for (int j = 0; j < kRun; ++j)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) acc[j][ch] = bdw[ch];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          uint32_t v[4 * kQuads];
#pragma unroll
          for (int k = 0; k < 4 * kQuads; ++k)
            v[k] = k < kCols ? src[dy * row_words + k * groups] : 0u;
          uint32_t tw[4][kQuads];   // channel, 4 consecutive columns
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            const uint32_t lo01 = __byte_perm(v[4 * q], v[4 * q + 1], 0x5140);
            const uint32_t hi01 = __byte_perm(v[4 * q], v[4 * q + 1], 0x7362);
            const uint32_t lo23 = __byte_perm(v[4 * q + 2], v[4 * q + 3], 0x5140);
            const uint32_t hi23 = __byte_perm(v[4 * q + 2], v[4 * q + 3], 0x7362);
            tw[0][q] = __byte_perm(lo01, lo23, 0x5410);
            tw[1][q] = __byte_perm(lo01, lo23, 0x7632);
            tw[2][q] = __byte_perm(hi01, hi23, 0x5410);
            tw[3][q] = __byte_perm(hi01, hi23, 0x7632);
          }
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
              const int pos = S * j, q = pos / 4, sh = pos % 4;
              const uint32_t win = sh == 0 ? tw[ch][q]
                  : __funnelshift_r(tw[ch][q], tw[ch][q + 1], 8 * sh);
              acc[j][ch] = __dp4a(static_cast<int>(win),
                                  static_cast<int>(wrow[ch][dy]), acc[j][ch]);
            }
        }
        uint32_t* dst = f2w + (tr * p.w2 + c0) * f2_words + cg;
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          uint32_t packed = 0;
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            const int q = requant(acc[j][ch], mdw[ch], p.zp_f2, p.zp_f2,
                                  p.q6_f2);
            packed |= static_cast<uint32_t>(q & 0xff) << (8 * ch);
          }
          if (c0 + j < p.w2) dst[j * f2_words] = packed;
        }
      }
    }
    __syncthreads();

    // ---- Projection: y = requant(F2 . w_proj + b_proj) to int8 NHWC -------
    // A warp takes an m-tile and a range of n-tiles, two at a time.
    {
      const int pixels = t.rows * p.w2;
      const int mtiles = (pixels + 15) / 16;
      const int ntiles = cout / 8;
      const int ksteps = p.kp / kMmaK;
      const int split = max(1, min((ntiles + 1) / 2, kWarps / mtiles));
      const int per = 2 * (((ntiles + 1) / 2 + split - 1) / split);
      int8_t* out_tile = p.out
          + (static_cast<size_t>(t.img) * p.h2 + t.row0) * p.w2 * cout;
      for (int item = warp; item < mtiles * split; item += kWarps) {
        const int mt = item / split;
        const int nt0 = (item - mt * split) * per;
        const int nt1 = min(ntiles, nt0 + per);
        const int pa = mt * 16 + g, pb = pa + 8;
        const int8_t* fa = s_f2 + pa * p.kps + t4 * 4;
        const int8_t* fb = s_f2 + pb * p.kps + t4 * 4;
        for (int nt = nt0; nt < nt1; nt += 2) {
          const bool two = nt + 1 < nt1;
          const int8_t* w0 = s_wproj + (nt * 8 + g) * p.kps + t4 * 4;
          const int8_t* w1 = w0 + (two ? 8 * p.kps : 0);
          int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
          for (int ks = 0; ks < ksteps; ++ks) {
            const uint32_t a0 = ld32(fa + ks * kMmaK);
            const uint32_t a1 = ld32(fb + ks * kMmaK);
            mma_s8(d[0], a0, a1, ld32(w0 + ks * kMmaK));
            mma_s8(d[1], a0, a1, ld32(w1 + ks * kMmaK));
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (i == 1 && !two) break;
            const int n = (nt + i) * 8 + t4 * 2;
            const int2 b = *reinterpret_cast<const int2*>(s_bproj + n);
            const float2 mm = *reinterpret_cast<const float2*>(s_mproj + n);
            if (pa < pixels)
              st16(out_tile + static_cast<size_t>(pa) * cout + n,
                   requant(d[i][0] + b.x, mm.x, p.zp_out, -128, 127),
                   requant(d[i][1] + b.y, mm.y, p.zp_out, -128, 127));
            if (pb < pixels)
              st16(out_tile + static_cast<size_t>(pb) * cout + n,
                   requant(d[i][2] + b.x, mm.x, p.zp_out, -128, 127),
                   requant(d[i][3] + b.y, mm.y, p.zp_out, -128, 127));
          }
        }
      }
    }
    // The next iteration's first __syncthreads orders these F2 reads before
    // the next depthwise writes, and the expansion's reads of this strip
    // buffer before the prefetch that overwrites it.
  }
}

using KernelFn = void (*)(Params);

// The instantiations, by (stride - 1) * kMaxKSteps + KS - 1.
const KernelFn kKernels[2 * kMaxKSteps] = {
    fused_dsc_kernel<1, 1>, fused_dsc_kernel<1, 2>, fused_dsc_kernel<1, 3>,
    fused_dsc_kernel<1, 4>, fused_dsc_kernel<2, 1>, fused_dsc_kernel<2, 2>,
    fused_dsc_kernel<2, 3>, fused_dsc_kernel<2, 4>};
int g_opted_in[2 * kMaxKSteps][64] = {};

int kernel_index(int stride, int cin) {
  return (stride - 1) * kMaxKSteps + (cin + kMmaK - 1) / kMmaK - 1;
}

}  // namespace

// Blocks of the kernel for `stride` and `cin` that fit on one SM of the
// current card with `smem` bytes of dynamic shared memory each, or
// -cudaError.
extern "C" int fused_dsc_occupancy(int stride, int cin, int smem) {
  if ((stride != 1 && stride != 2) || cin <= 0 || cin > kMmaK * kMaxKSteps)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int k = kernel_index(stride, cin);
  int n = 0;
  cudaError_t e = opt_in(kKernels[k], smem, g_opted_in[k]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kKernels[k],
                                                      kThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int fused_dsc_launch(
    const void* x, const void* w_exp, const void* w_dw9, const void* w_proj,
    const void* b_exp, const void* b_dw, const void* b_proj,
    const void* m_exp, const void* m_dw, const void* m_proj, void* out,
    int batch, int h, int w, int cin, int cmid, int cout, int stride,
    int tile_rows, int n_tiles, int units, int blocks_per_sm, int grid,
    int smem, int kx, int kp, int kxs, int kps, int wf1, int runs, int zp_f1,
    int zp_f2, int zp_out, int q6_f1, int q6_f2, void* stream) {
  const int plan[12] = {tile_rows, n_tiles, units, blocks_per_sm, grid, smem,
                        kx, kp, kxs, kps, wf1, runs};
  Layout ly;
  const int r = check_plan(batch, h, w, cin, cmid, cout, stride, plan, &ly);
  if (r != 0) return r;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w_exp = static_cast<const int8_t*>(w_exp);
  p.w_dw9 = static_cast<const int8_t*>(w_dw9);
  p.w_proj = static_cast<const int8_t*>(w_proj);
  p.b_exp = static_cast<const int32_t*>(b_exp);
  p.b_dw = static_cast<const int32_t*>(b_dw);
  p.b_proj = static_cast<const int32_t*>(b_proj);
  p.m_exp = static_cast<const float*>(m_exp);
  p.m_dw = static_cast<const float*>(m_dw);
  p.m_proj = static_cast<const float*>(m_proj);
  p.out = static_cast<int8_t*>(out);
  p.h = h; p.w = w; p.cin = cin; p.cmid = cmid; p.cout = cout;
  p.h2 = (h + stride - 1) / stride;
  p.w2 = (w + stride - 1) / stride;
  p.tile_rows = tile_rows;
  p.n_tiles = n_tiles;
  p.units = units;
  p.kx = kx; p.kp = kp; p.kxs = kxs; p.kps = kps; p.wf1 = wf1; p.runs = runs;
  p.off_wproj = static_cast<int>(ly.off_wproj);
  p.off_params = static_cast<int>(ly.off_params);
  p.off_x = static_cast<int>(ly.off_x);
  p.x_bytes = static_cast<int>(ly.x_bytes);
  p.off_f1 = static_cast<int>(ly.off_f1);
  p.off_f2 = static_cast<int>(ly.off_f2);
  p.f1_trash = ((tile_rows - 1) * stride + 3) * wf1 * cmid;
  p.zp_f1 = zp_f1; p.zp_f2 = zp_f2; p.zp_out = zp_out;
  p.q6_f1 = q6_f1 < 127 ? q6_f1 : 127;
  p.q6_f2 = q6_f2 < 127 ? q6_f2 : 127;
  // The opt-in above 48 KB is made once per kernel, device and size, so a
  // launch inside a CUDA-graph capture makes no attribute call.
  const int k = kernel_index(stride, cin);
  cudaError_t e = opt_in(kKernels[k], static_cast<size_t>(smem),
                         g_opted_in[k]);
  if (e != cudaSuccess) return static_cast<int>(e);
  kKernels[k]<<<static_cast<unsigned>(grid), kThreads,
                static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_dsc_error_string(int code) {
  if (code == kBadArgs)
    return "widths or stride the fused DSC kernel does not take";
  if (code == kBadPlan) return g_refusal;
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
