// Flash attention for Hopper (sm_90a): online-softmax attention with causal,
// sliding-window and logit-softcap masking, and GQA by head index.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention). It computes what the plain
// version src/repro_torch/kernels/ref.py::attention_ref computes:
//
//   s = (q . k) * sm_scale            f32 scores, scale after the dot
//   s = softcap * tanh(s / softcap)   when softcap is given (tanhf, accurate)
//   masked: k >= Tk, causal k > q, window q - k >= window
//   o = softmax(s) @ v                P cast to v's type before the PV dot,
//                                     f32 running max / sum / accumulator
//
// A row with no valid key returns zeros, as the plain version does (the
// Pallas kernel returns the mean of V there; the model's path never has
// such a row: it is causal with window >= 1).
//
// Layout. q, o: (B, Tq, H, d); k, v: (B, Tk, Hkv, d), all contiguous. Query
// head h reads KV head h / (H / Hkv): GQA without repeating K and V. The
// (BH, T, d) layout of ops.attention is the case H = Hkv = 1.
//
// bf16 design (the serving path). One warpgroup (128 threads) per (64-row
// query tile, b, h); the grid is (query tiles, B * H), and under a causal
// mask the block order is remapped so that the query tiles with the most
// K/V tiles start first. K/V tiles wholly above the causal diagonal or
// wholly before the window are skipped (exact: their weights are 0).
//   - Loads: TMA. Q, K and V each have a 4-d tensor map (d, heads, T, B)
//     with a (64, 1, 64, 1) box and the 128-byte swizzle, so a tile of
//     64 rows lands as d_pad / 64 swizzled 8 KB chunks, d padded to a
//     multiple of 64 by the map's zero fill (and ragged T zero-filled
//     within its own sequence). Q is loaded once; K and V go through a
//     2-stage ring, one mbarrier per stage: one thread issues tile t + 1
//     before the products of tile t.
//   - S = Q K^T: wgmma m64n64k16, both operands K-major from shared
//     memory, d_pad / 16 instructions in one commit group; S stays in the
//     f32 accumulator registers (32 per thread).
//   - Softmax on the accumulator layout: a thread holds two rows of 16
//     columns; row max and row sum reduce over the quad with two shuffles.
//     Scores are kept in log2 units (exp2f with log2e folded into the
//     scale). The mask arithmetic runs only on tiles that cross the
//     diagonal, the window edge or Tk.
//   - O += P V: wgmma m64n{d_pad}k16 with A = P from registers (bf16 pairs
//     packed straight from S's accumulators) and B = V, MN-major through
//     the descriptor's transpose bit. O is 64 x d_pad f32 in registers (128
//     per thread at d 256); the online rescale by alpha is in registers.
//   - Epilogue: O / l in f32 (zeros where l == 0), bf16 stores of the real
//     columns, ragged Tq masked.
//   Shared memory: Q + 2 x (K + V) tiles, 160 KB at d 256 (80 KB at
//   d <= 128, two blocks per SM). The tensor maps are encoded on the host
//   per call (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
//   nothing links libcuda) and passed as __grid_constant__ parameters,
//   which a CUDA graph captures by value.
// f32 design (tests and the f32 checks): one block of 4 warps per 32-row
// query tile, synchronous 16-byte loads into shared memory, scalar f32 FMA
// (no TF32) for both products, the accumulator in shared memory.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). At
// gemma2-9b prefill (B 4, P 512, H 16, Hkv 8, d 256, causal) one launch
// needs 4.3 GFLOP of causal products (~4.3 us) and moves 50 MB of q, k, v
// and o (~15 us): bound by bytes. At B 1, P 4096 it needs 137 GFLOP against
// 101 MB: bound by operations (0.139 ms). Left for later: a producer warp
// (warp specialisation), two consumer warpgroups that overlap one's softmax
// with the other's products, a persistent grid, and fp8.
//
// Interface: plain C, loaded with ctypes. The launcher takes device
// pointers, sizes, the plan's shared memory and a stream; launches on that
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (or kEncodeFailed when a tensor map cannot be encoded,
// kBadPlan when the shared memory is not the kernel's own).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBadPlan = -2;   // a handed plan the kernel cannot run
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, kv_heads, tq, tk, d;
  int causal, window;        // window <= 0: no window
  int has_softcap;
  float softcap, sm_scale;
};

// ===========================================================================
// f32: scalar path
// ===========================================================================

// Shared-memory layout, in bytes, for one f32 block.
template <int BQ, int BK>
__host__ __device__ inline size_t f32_smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(BQ) * d + 2 * BK * d + BQ * BK)
       + sizeof(float) * (static_cast<size_t>(BQ) * BK + BQ * d + 3 * BQ);
}

// Copy `rows` rows of d floats, row stride `stride` elements, into a dense
// (rows_cap, d) tile; rows past `rows` are zero. d * 4 is a multiple of 16
// bytes, so each thread moves 16 bytes at a time.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int rows_cap, int d,
                                          size_t stride) {
  constexpr int kVec = 4;
  const int vec_per_row = d / kVec;
  for (int i = threadIdx.x; i < rows_cap * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * d + c) = val;
  }
}

// One block of 4 warps per (query tile of BQ rows, b, h); each warp owns
// BQ/4 query rows for the whole K/V walk, so only the K/V loads need the
// block to synchronise.
template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  constexpr int kRows = BQ / kWarps;   // query rows per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d;
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + BQ * d;
  float* s_v = s_k + BK * d;
  float* s_p = s_v + BK * d;                               // (BQ, BK)
  float* s_s = s_p + BQ * BK;                              // (BQ, BK)
  float* s_acc = s_s + BQ * BK;                            // (BQ, d)
  float* s_m = s_acc + BQ * d;
  float* s_l = s_m + BQ;
  float* s_alpha = s_l + BQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const size_t q_stride = static_cast<size_t>(p.heads) * d;
  const size_t k_stride = static_cast<size_t>(p.kv_heads) * d;
  const float* q = static_cast<const float*>(p.q)
      + (static_cast<size_t>(b) * p.tq + q0) * q_stride + static_cast<size_t>(h) * d;
  const float* kbase = static_cast<const float*>(p.k)
      + static_cast<size_t>(b) * p.tk * k_stride + static_cast<size_t>(kvh) * d;
  const float* vbase = static_cast<const float*>(p.v)
      + static_cast<size_t>(b) * p.tk * k_stride + static_cast<size_t>(kvh) * d;
  const int q_rows = min(BQ, p.tq - q0);

  load_rows(s_q, q, q_rows, BQ, d, q_stride);
  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) s_acc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }

  // K/V tiles that hold a valid key for some row of this query tile.
  const int last_q = q0 + q_rows - 1;
  const int k_end = p.causal ? min(p.tk, last_q + 1) : p.tk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;
  const int r0 = warp * kRows;                 // this warp's first row

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_rows(s_k, kbase + k0 * k_stride, min(BK, p.tk - k0), BK, d, k_stride);
    load_rows(s_v, vbase + k0 * k_stride, min(BK, p.tk - k0), BK, d, k_stride);
    __syncthreads();

    // ---- S = Q K^T for this warp's rows -----------------------------------
    for (int i = lane; i < kRows * BK; i += 32) {
      const int r = r0 + i / BK;
      const int c = i % BK;
      const float* qr = s_q + r * d;
      const float* kr = s_k + c * d;
      float dot = 0.f;
      for (int kk = 0; kk < d; ++kk) dot = fmaf(qr[kk], kr[kk], dot);
      s_s[r * BK + c] = dot;
    }
    __syncwarp();

    // ---- online softmax over this tile, one row at a time ------------------
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = r0 + rr;
      const int qpos = q0 + r;
      float sv[(BK + 31) / 32];
      bool ok[(BK + 31) / 32];
      float m_cur = kNegInf;
      for (int j = 0; j < (BK + 31) / 32; ++j) {
        const int c = lane + 32 * j;
        const int kpos = k0 + c;
        float s = s_s[r * BK + c] * p.sm_scale;
        if (p.has_softcap) s = p.softcap * tanhf(s / p.softcap);
        bool valid = kpos < p.tk;
        if (p.causal) valid = valid && qpos >= kpos;
        if (p.window > 0) valid = valid && (qpos - kpos) < p.window;
        ok[j] = valid;
        sv[j] = valid ? s : kNegInf;
        m_cur = fmaxf(m_cur, sv[j]);
      }
      for (int off = 16; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int j = 0; j < (BK + 31) / 32; ++j) {
        const float pv = ok[j] ? expf(sv[j] - m_new) : 0.f;
        sum += pv;
        s_p[r * BK + lane + 32 * j] = pv;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[r] = alpha;
        s_l[r] = alpha * s_l[r] + sum;
        s_m[r] = m_new;
      }
    }
    __syncwarp();
    for (int i = lane; i < kRows * d; i += 32) {
      const int r = r0 + i / d;
      s_acc[r * d + i % d] *= s_alpha[r];
    }
    __syncwarp();

    // ---- O += P V for this warp's rows ------------------------------------
    for (int i = lane; i < kRows * d; i += 32) {
      const int r = r0 + i / d;
      const int c = i % d;
      const float* pr = s_p + r * BK;
      float acc = s_acc[r * d + c];
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], s_v[j * d + c], acc);
      s_acc[r * d + c] = acc;
    }
  }
  __syncthreads();

  // ---- o = acc / l (rows with no valid key: l = 0 -> zeros) ---------------
  float* o = static_cast<float*>(p.o)
      + (static_cast<size_t>(b) * p.tq + q0) * q_stride + static_cast<size_t>(h) * d;
  for (int i = threadIdx.x; i < q_rows * d; i += blockDim.x) {
    const int r = i / d;
    const float l = s_l[r];
    const float denom = l == 0.f ? 1.f : l;
    o[r * q_stride + i % d] = s_acc[r * d + i % d] / denom;
  }
}

template <int BQ, int BK>
int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  static int opted_in[64] = {0};
  const size_t smem = f32_smem_bytes<BQ, BK>(p.d);
  const long long q_tiles = (p.tq + BQ - 1) / BQ;
  const long long bh = static_cast<long long>(batch) * p.heads;
  if (q_tiles > INT_MAX || bh > 65535 || smem > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = opt_in(flash_f32_kernel<BQ, BK>, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(bh));
  flash_f32_kernel<BQ, BK><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bf16: wgmma with the accumulators in registers, a TMA-fed K/V ring
// ===========================================================================

constexpr int kBQ = 64;          // query rows per block (one warpgroup)
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kBox = 64;         // bf16 columns per TMA box: 128 bytes
constexpr int kStages = 2;       // K/V ring depth
constexpr uint32_t kChunk = kBox * 64 * 2;   // one 64-row box: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of one 64-row tile of d_pad columns, and of the block's shared
// memory: 1 KB of alignment slack, Q, kStages x (K, V), the barriers. The
// launch takes kernels/flash_attention.py::plan's smem_bytes and refuses a
// value other than this.
__host__ __device__ constexpr uint32_t tile_bytes(int dp) {
  return static_cast<uint32_t>(dp / kBox) * kChunk;
}
__host__ __device__ constexpr size_t bf16_smem_bytes(int dp) {
  return 1024 + static_cast<size_t>(tile_bytes(dp)) * (1 + 2 * kStages)
       + 8 * (kStages + 1);
}

// The wgmma instructions, operand lists spelled out (PTX names every
// accumulator register).
// S (64 x 64, f32) (+)= A (64 x 16) . B (64 x 16)^T, both bf16 K-major in
// shared memory. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16
// MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// O (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16
// MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// O (64 x 192, f32) += A (64 x 16, bf16 in registers) . B (16 x 192, bf16
// MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// O (64 x 256, f32) += A (64 x 16, bf16 in registers) . B (16 x 256, bf16
// MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}


// O (64 x DP) += P (64 x 16) . V (16 x DP), one instruction of width DP.
template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  static_assert(DP == 64 || DP == 128 || DP == 192 || DP == 256, "d_pad");
  if constexpr (DP == 64) wgmma_rs_n64(o, a, desc_v);
  else if constexpr (DP == 128) wgmma_rs_n128(o, a, desc_v);
  else if constexpr (DP == 192) wgmma_rs_n192(o, a, desc_v);
  else wgmma_rs_n256(o, a, desc_v);
}

// One warpgroup per (64-row query tile, b, h); DP is d padded to a multiple
// of 64. Accumulator layout (wgmma m64nNk16, f32): thread (warp w, lane
// 4g + c) holds, for each 8-column block j, rows 16w + g (registers 4j,
// 4j + 1) and 16w + g + 8 (4j + 2, 4j + 3) at columns 8j + 2c and 8j + 2c + 1.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    const Params p, const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v) {
  constexpr int kChunks = DP / kBox;
  constexpr uint32_t kTile = tile_bytes(DP);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bars = base + kTile * (1 + 2 * kStages);  // Q, then stages
  auto stage_k = [&](int stage) { return base + kTile * (1 + 2 * stage); };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int c = tid % 4;

  // Causal: the last query tiles see the most keys, so they go first.
  const int n_bh = gridDim.y;
  const int lin = blockIdx.x + blockIdx.y * gridDim.x;
  const int bh = lin % n_bh;
  const int qt = p.causal ? static_cast<int>(gridDim.x) - 1 - lin / n_bh
                         : lin / n_bh;
  const int q0 = qt * kBQ;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);

  // K/V tiles that hold a valid key for some row of this query tile.
  const int last_q = min(q0 + kBQ, p.tq) - 1;
  const int k_end = p.causal ? min(p.tk, last_q + 1) : p.tk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int n_tiles = max(0, (k_end + kBK - 1) / kBK - kt_begin);

  auto load_kv = [&](int t) {   // tile t of this block into its stage
    const int stage = t % kStages;
    const uint32_t bar = bars + 8 * (1 + stage);
    const uint32_t sk = stage_k(stage);
    const int k0 = (kt_begin + t) * kBK;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      tma_load_4d(sk + ch * kChunk, &tm_k, bar, ch * kBox, kvh, k0, b);
      tma_load_4d(sk + kTile + ch * kChunk, &tm_v, bar, ch * kBox, kvh, k0, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, kTile);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
      tma_load_4d(s_q + ch * kChunk, &tm_q, bars, ch * kBox, h, q0, b);
    for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) load_kv(t);
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's part of the sum
  // log2-unit score: x = raw * scale * log2e, or with the softcap
  // x = softcap * log2e * tanh(raw * scale / softcap).
  const float pre = p.has_softcap ? p.sm_scale / p.softcap
                                  : p.sm_scale * kLog2e;
  const float post = p.softcap * kLog2e;
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8

  mbar_wait(bars, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) __syncthreads();   // tile t - 1 is done: its stage is free
    if (tid == 0 && t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    const int stage = t % kStages;
    mbar_wait(bars + 8 * (1 + stage), (t / kStages) & 1);
    __syncwarp();
    const uint32_t sk = stage_k(stage);
    const uint32_t sv = sk + kTile;
    const int k0 = (kt_begin + t) * kBK;

    // ---- S = Q K^T: K-major operands, 16 columns of d per instruction ----
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks / 4) * kChunk + (ks % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(s_q + off, 16, 1024),
                   sw128_desc(sk + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);

    // ---- online softmax on the accumulator layout ------------------------
    const bool edge = k0 + kBK > p.tk || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window > 0 && q0 + kBQ - 1 - k0 >= p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        x = p.has_softcap ? post * tanhf(x * pre) : x * pre;
        if (edge) {
          const int key = k0 + 8 * j + 2 * c + (e & 1);
          const int qpos = row0 + 8 * (e >> 1);
          bool ok = key < p.tk;
          if (p.causal) ok = ok && key <= qpos;
          if (p.window > 0) ok = ok && qpos - key < p.window;
          if (!ok) x = -INFINITY;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // No valid key yet: subtract 0, so exp2(-inf) = 0 and alpha = 0.
      msub[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - msub[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float pv = exp2f(s[e] - msub[(e >> 1) & 1]);
      l[(e >> 1) & 1] += pv;
      s[e] = pv;
    }
    // P as the A operand of m64nNk16, 16 keys per instruction: the
    // accumulator blocks 2kk and 2kk + 1 are the A fragment's registers.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // ---- O += P V: V MN-major, 16 keys (2 KB of rows) per instruction -----
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DP>(o, pa[kk], sw128_desc(sv + kk * 16 * 128, kChunk, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DP / 2>(o);
  }

  // ---- o = acc / l (rows with no valid key: l = 0 -> zeros) ---------------
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  const size_t q_stride = static_cast<size_t>(p.heads) * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + 8 * i;
    if (qpos >= p.tq) continue;
    bf16* orow = static_cast<bf16*>(p.o)
        + (static_cast<size_t>(b) * p.tq + qpos) * q_stride
        + static_cast<size_t>(h) * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < p.d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
}

// The (B, T, heads, d) bf16 tensor at `ptr` as a 4-d map (d, heads, T, B)
// with a (64, 1, 64, 1) box and the 128-byte swizzle; out-of-range columns
// and rows read as zeros.
int encode_bthd(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
                int heads, int t, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * t};
  const cuuint32_t box[4] = {kBox, 1, kBQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  g_last_encode_result = static_cast<int>(r);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <int DP>
int launch_bf16(const Params& p, int batch, int plan_smem,
                cudaStream_t stream) {
  static_assert(kBQ == kBK, "one box height serves Q, K and V");
  static int opted_in[64] = {0};
  const size_t smem = bf16_smem_bytes(DP);
  if (static_cast<size_t>(plan_smem) != smem) return kBadPlan;
  const long long q_tiles = (p.tq + kBQ - 1) / kBQ;
  const long long bh = static_cast<long long>(batch) * p.heads;
  if (q_tiles > INT_MAX || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = nullptr;
  cudaError_t e = encode_tiled(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_q, tm_k, tm_v;
  int r = encode_bthd(fn, &tm_q, p.q, p.d, p.heads, p.tq, batch);
  if (r == 0) r = encode_bthd(fn, &tm_k, p.k, p.d, p.kv_heads, p.tk, batch);
  if (r == 0) r = encode_bthd(fn, &tm_v, p.v, p.d, p.kv_heads, p.tk, batch);
  if (r != 0) return r;
  e = opt_in(flash_wgmma_kernel<DP>, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(bh));
  flash_wgmma_kernel<DP><<<grid, kThreads, smem, stream>>>(p, tm_q, tm_k,
                                                           tm_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: none. has_softcap 0/1.
// smem: bf16, the plan's shared memory (kernels/flash_attention.py::plan),
// refused unless it is the kernel's own; f32 plans nothing and passes 0.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int kv_heads, int tq, int tk, int d, int causal,
    int window, int has_softcap, float softcap, float sm_scale, int smem,
    void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      tq <= 0 || tk <= 0 || d <= 0 || d % 16 != 0 || d > 256 ||
      (has_softcap && !(softcap > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.heads = heads; p.kv_heads = kv_heads; p.tq = tq; p.tk = tk; p.d = d;
  p.causal = causal; p.window = window; p.has_softcap = has_softcap;
  p.softcap = softcap; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch ((d + kBox - 1) / kBox) {
      case 1: return launch_bf16<64>(p, batch, smem, s);
      case 2: return launch_bf16<128>(p, batch, smem, s);
      case 3: return launch_bf16<192>(p, batch, smem, s);
      default: return launch_bf16<256>(p, batch, smem, s);
    }
  }
  if (dtype == 0)
    return smem != 0 ? kBadPlan : launch_f32<32, 32>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  static char buf[96];
  if (code == kBadPlan)
    return "the plan's shared memory is not the kernel's own (bf16), or not "
           "0 (f32)";
  if (code == kEncodeFailed) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             g_last_encode_result);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
