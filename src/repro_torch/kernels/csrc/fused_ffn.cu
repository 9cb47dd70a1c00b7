// Fused gated FFN for Hopper (sm_90a): y = act(x Wg) * (x Wu) @ Wd, with the
// (T, d_ff) intermediate kept in shared memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ffn.py::
// _fused_ffn_kernel (launched by fused_ffn_pallas). It computes what the
// plain version src/repro_torch/kernels/ref.py::fused_ffn_ref computes:
// f32 accumulation of both expansions, h = act(g) * u in f32, h cast to x's
// type before the down projection, f32 accumulation of the projection, the
// output cast to x's type. Ungated (no Wg): h = act(x Wu).
//
// Design. The Pallas kernel holds a (block_t, d_model) f32 accumulator for
// the whole d_ff loop. At d_model 3584 that is 14 KB per token row, and a
// block has 227 KB of shared memory, so one block cannot hold that design
// at a useful token tile. This kernel splits d_ff instead (split-K over the
// down projection):
//   grid = (token tiles of BT rows, d_ff splits of FR columns);
//   1. expansion: the block computes h (BT x FR) = act(x Wg) * (x Wu) for
//      its columns and keeps it in shared memory as x's type;
//   2. projection: it multiplies h by Wd[its FR rows, :] and writes the
//      f32 partial (BT x d_model) to a workspace slice of its own;
//   3. a second, small kernel sums the splits' partials in a fixed order
//      and casts to x's type (deterministic: no atomics).
// h, the (T, d_ff) intermediate, never goes to device memory; the partial
// outputs (splits x T x d_model f32) do. The launcher picks the split so
// that the grid has at least two blocks per SM: FR 1024 (14 splits) at
// gemma2-9b prefill, FR 128 (112 splits) at decode.
//   bf16: nvcuda::wmma 16x16x16 tiles with f32 accumulate; 8 warps; each
//         expansion sub-block is 128 d_ff columns, each projection block 128
//         d_model columns, staged through shared memory in k-steps of 32.
//   f32:  scalar f32 FMA (no TF32), BT 16.
// Ragged T and d_ff are masked by zero-filled loads: a zero weight column
// gives h = act(0) * 0 = 0 (gated) or act(0) = 0 (ungated, every act here).
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). At
// gemma2-9b (d_model 3584, d_ff 14336) prefill, T = 2048, one launch is
// 0.63 TFLOP (0.64 ms): bound by operations. At decode, T = 4, it reads
// 308 MB of weights (0.092 ms): bound by bytes. This simple kernel stages
// tiles synchronously with wmma, and adds the workspace round trip; wgmma,
// TMA pipelines and a cluster reduction of the partials are later work.
//
// Interface: plain C, loaded with ctypes. The launcher takes device
// pointers (the workspace is allocated by the caller), sizes and a stream;
// launches on that stream, does not synchronise, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;                      // d_ff / d_model columns per sub-block
constexpr int kBK = 32;                       // k-step of the staged products
constexpr int kPad = 8;                       // smem row padding (bf16 elements)
constexpr size_t kDefaultSmem = 48 * 1024;

enum Act { kSilu = 0, kGelu = 1, kReluSq = 2, kRelu = 3 };

struct Params {
  const void* x;       // (T, D)
  const void* wg;      // (D, F) or null (ungated)
  const void* wu;      // (D, F)
  const void* wd;      // (F, D)
  float* ws;           // (splits, T_pad, D) f32 partials
  void* y;             // (T, D)
  int t, d, f, fr, t_pad, act;
};

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case kSilu: return x * (1.f / (1.f + expf(-x)));
    case kGelu: {
      const float c = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kReluSq: { const float r = fmaxf(x, 0.f); return r * r; }
    default: return fmaxf(x, 0.f);
  }
}

// Copy a (rows, cols) tile of a row-major bf16 matrix with row stride
// `stride` from (r0, c0) into shared memory with leading dimension ld;
// elements at row >= n_rows or column >= n_cols are zero. stride, n_cols,
// c0 and cols are multiples of 8.
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      int stride, int n_rows, int n_cols,
                                      int r0, int c0, int rows, int cols) {
  const int vec_per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows && c0 + c < n_cols)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r0 + r) * stride + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int BT>
struct Bf16Tile {
  static constexpr int kWM = BT / 16;              // warps along tokens
  static constexpr int kWN = kWarps / kWM;         // warps along columns
  static constexpr int kFN = kBN / (kWN * 16);     // 16-col fragments per warp
  static constexpr int kLdX = kBK + kPad;
  static constexpr int kLdW = kBN + kPad;
  static constexpr int kLdS = kBN + 4;             // f32 scratch
  static size_t smem(int fr) {
    return sizeof(bf16) * (static_cast<size_t>(BT) * (fr + kPad)   // h
                           + BT * kLdX                             // x step
                           + 2 * kBK * kLdW)                       // Wg, Wu/Wd step
         + sizeof(float) * BT * kLdS;                              // epilogue
  }
};

template <int BT>
__global__ void __launch_bounds__(kThreads) ffn_bf16_kernel(const Params p) {
  using L = Bf16Tile<BT>;
  static_assert(BT % 16 == 0 && kWarps % L::kWM == 0 && L::kFN >= 1, "tile");
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld_h = p.fr + kPad;
  bf16* s_h = reinterpret_cast<bf16*>(smem);                 // (BT, FR)
  bf16* s_x = s_h + BT * ld_h;                               // (BT, kBK)
  bf16* s_w0 = s_x + BT * L::kLdX;                           // (kBK, kBN)
  bf16* s_w1 = s_w0 + kBK * L::kLdW;                         // (kBK, kBN)
  float* s_e = reinterpret_cast<float*>(s_w1 + kBK * L::kLdW);   // (BT, kBN)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / L::kWN;                // 16-row strip
  const int wn = warp % L::kWN;                // column group
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int f0 = split * p.fr;
  const int f_len = min(p.fr, p.f - f0);
  const int f_end = f0 + f_len;   // d_ff columns past this split load as zero
  const bool gated = p.wg != nullptr;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* wg = static_cast<const bf16*>(p.wg);
  const bf16* wu = static_cast<const bf16*>(p.wu);
  const bf16* wd = static_cast<const bf16*>(p.wd);

  // ---- 1. expansion: h[:, fb:fb+kBN] for each 128-column sub-block --------
  for (int fb = 0; fb < f_len; fb += kBN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> g[L::kFN], u[L::kFN];
    for (int j = 0; j < L::kFN; ++j) {
      wmma::fill_fragment(g[j], 0.f);
      wmma::fill_fragment(u[j], 0.f);
    }
    for (int k0 = 0; k0 < p.d; k0 += kBK) {
      __syncthreads();
      stage(s_x, L::kLdX, x, p.d, p.t, p.d, t0, k0, BT, kBK);
      if (gated)
        stage(s_w0, L::kLdW, wg, p.f, p.d, f_end, k0, f0 + fb, kBK, kBN);
      stage(s_w1, L::kLdW, wu, p.f, p.d, f_end, k0, f0 + fb, kBK, kBN);
      __syncthreads();
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, s_x + wm * 16 * L::kLdX + kk, L::kLdX);
        for (int j = 0; j < L::kFN; ++j) {
          const int col = (wn * L::kFN + j) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          if (gated) {
            wmma::load_matrix_sync(b, s_w0 + kk * L::kLdW + col, L::kLdW);
            wmma::mma_sync(g[j], a, b, g[j]);
          }
          wmma::load_matrix_sync(b, s_w1 + kk * L::kLdW + col, L::kLdW);
          wmma::mma_sync(u[j], a, b, u[j]);
        }
      }
    }
    // mix in f32 (both fragments share one element layout), then h as bf16
    for (int j = 0; j < L::kFN; ++j) {
      for (int e = 0; e < u[j].num_elements; ++e)
        u[j].x[e] = gated ? act_fn(g[j].x[e], p.act) * u[j].x[e]
                          : act_fn(u[j].x[e], p.act);
      wmma::store_matrix_sync(s_e + wm * 16 * L::kLdS + (wn * L::kFN + j) * 16,
                              u[j], L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * L::kFN * 16; i += 32) {
      const int r = wm * 16 + i / (L::kFN * 16);
      const int c = (wn * L::kFN) * 16 + i % (L::kFN * 16);
      s_h[r * ld_h + fb + c] = __float2bfloat16_rn(s_e[r * L::kLdS + c]);
    }
  }

  // ---- 2. projection: partial[:, nb:nb+kBN] = h @ Wd[f0:f0+f_len, nb:] ----
  float* ws = p.ws + (static_cast<size_t>(split) * p.t_pad + t0) * p.d;
  for (int nb = 0; nb < p.d; nb += kBN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[L::kFN];
    for (int j = 0; j < L::kFN; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < f_len; k0 += kBK) {
      __syncthreads();   // h complete; previous Wd step consumed
      stage(s_w0, L::kLdW, wd, p.d, f_end, p.d, f0 + k0, nb, kBK, kBN);
      __syncthreads();
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, s_h + wm * 16 * ld_h + k0 + kk, ld_h);
        for (int j = 0; j < L::kFN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, s_w0 + kk * L::kLdW + (wn * L::kFN + j) * 16,
                                 L::kLdW);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    for (int j = 0; j < L::kFN; ++j) {
      const int col = nb + (wn * L::kFN + j) * 16;
      if (col < p.d)
        wmma::store_matrix_sync(ws + static_cast<size_t>(wm * 16) * p.d + col,
                                acc[j], p.d, wmma::mem_row_major);
    }
  }
}

// f32: BT 16 token rows; each thread owns one column of a 128-column block
// and 8 of the 16 rows. Scalar FMA, x staged through shared memory.
constexpr int kF32BT = 16;

__global__ void __launch_bounds__(kThreads) ffn_f32_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);       // (BT, FR)
  float* s_x = s_h + kF32BT * p.fr;                  // (BT, kBK)
  const int col = threadIdx.x % kBN;
  const int row0 = threadIdx.x / kBN;                // 0 or 1; rows row0 + 2i
  constexpr int kR = kF32BT * kBN / kThreads;        // 8 rows per thread
  const int t0 = blockIdx.x * kF32BT;
  const int split = blockIdx.y;
  const int f0 = split * p.fr;
  const int f_len = min(p.fr, p.f - f0);
  const bool gated = p.wg != nullptr;
  const float* x = static_cast<const float*>(p.x);
  const float* wg = static_cast<const float*>(p.wg);
  const float* wu = static_cast<const float*>(p.wu);
  const float* wd = static_cast<const float*>(p.wd);

  for (int fb = 0; fb < f_len; fb += kBN) {
    const int fc = f0 + fb + col;
    const bool in = fb + col < f_len;
    float g[kR], u[kR];
    for (int i = 0; i < kR; ++i) g[i] = u[i] = 0.f;
    for (int k0 = 0; k0 < p.d; k0 += kBK) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32BT * kBK; i += blockDim.x) {
        const int r = i / kBK, c = k0 + i % kBK;
        s_x[i] = (t0 + r < p.t && c < p.d)
                     ? x[static_cast<size_t>(t0 + r) * p.d + c] : 0.f;
      }
      __syncthreads();
      if (!in) continue;
      for (int kk = 0; kk < kBK && k0 + kk < p.d; ++kk) {
        const size_t w_off = static_cast<size_t>(k0 + kk) * p.f + fc;
        const float wuv = wu[w_off];
        const float wgv = gated ? wg[w_off] : 0.f;
        for (int i = 0; i < kR; ++i) {
          const float xv = s_x[(row0 + 2 * i) * kBK + kk];
          u[i] = fmaf(xv, wuv, u[i]);
          if (gated) g[i] = fmaf(xv, wgv, g[i]);
        }
      }
    }
    if (fb + col < p.fr)
      for (int i = 0; i < kR; ++i)
        s_h[(row0 + 2 * i) * p.fr + fb + col] =
            !in ? 0.f : gated ? act_fn(g[i], p.act) * u[i] : act_fn(u[i], p.act);
  }
  __syncthreads();

  float* ws = p.ws + (static_cast<size_t>(split) * p.t_pad + t0) * p.d;
  for (int nb = 0; nb < p.d; nb += kBN) {
    const int n = nb + col;
    if (n >= p.d) continue;
    float acc[kR];
    for (int i = 0; i < kR; ++i) acc[i] = 0.f;
    for (int j = 0; j < f_len; ++j) {
      const float w = wd[static_cast<size_t>(f0 + j) * p.d + n];
      for (int i = 0; i < kR; ++i)
        acc[i] = fmaf(s_h[(row0 + 2 * i) * p.fr + j], w, acc[i]);
    }
    for (int i = 0; i < kR; ++i)
      ws[static_cast<size_t>(row0 + 2 * i) * p.d + n] = acc[i];
  }
}

// y[t, n] = sum over splits of ws[s, t, n], in split order, cast to T.
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(
    const float* ws, T* y, int splits, int t, int t_pad, int d) {
  const size_t n = static_cast<size_t>(t) * d;
  const size_t slice = static_cast<size_t>(t_pad) * d;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * slice + i];
    if constexpr (sizeof(T) == 2) y[i] = __float2bfloat16_rn(s);
    else y[i] = s;
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, int* opted_in) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64 || static_cast<int>(smem) > opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) opted_in[dev] = static_cast<int>(smem);
  }
  return cudaSuccess;
}

template <int BT>
cudaError_t launch_bf16(const Params& p, int splits, cudaStream_t s) {
  static int opted_in[64] = {0};
  const size_t smem = Bf16Tile<BT>::smem(p.fr);
  cudaError_t e = opt_in(ffn_bf16_kernel<BT>, smem, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(p.t_pad / BT),
                  static_cast<unsigned>(splits));
  ffn_bf16_kernel<BT><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& p, int splits, cudaStream_t s) {
  static int opted_in[64] = {0};
  const size_t smem = sizeof(float) * (static_cast<size_t>(kF32BT) * p.fr
                                       + kF32BT * kBK);
  cudaError_t e = opt_in(ffn_f32_kernel, smem, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(p.t_pad / kF32BT),
                  static_cast<unsigned>(splits));
  ffn_f32_kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wg null: ungated. act: 0 silu, 1 gelu
// (tanh), 2 relu_sq, 3 relu. block_t: 16 or 64 (bf16), 16 (f32); fr: d_ff
// columns per split, a multiple of 128. ws: (ceil(f / fr), t_pad, d) f32,
// t_pad = t rounded up to block_t.
extern "C" int fused_ffn_launch(
    const void* x, const void* wg, const void* wu, const void* wd, void* ws,
    void* y, int dtype, int t, int d, int f, int act, int block_t, int fr,
    void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || d % 16 != 0 || f % 16 != 0 ||
      act < 0 || act > 3 || fr <= 0 || fr % kBN != 0 || !wu || !wd || !ws)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.wg = wg; p.wu = wu; p.wd = wd;
  p.ws = static_cast<float*>(ws); p.y = y;
  p.t = t; p.d = d; p.f = f; p.fr = fr; p.act = act;
  p.t_pad = (t + block_t - 1) / block_t * block_t;
  const long long splits = (f + fr - 1) / fr;
  if (p.t_pad / block_t > INT_MAX || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1 && block_t == 64) e = launch_bf16<64>(p, splits, s);
  else if (dtype == 1 && block_t == 16) e = launch_bf16<16>(p, splits, s);
  else if (dtype == 0 && block_t == kF32BT) e = launch_f32(p, splits, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(t) * d;
  const unsigned blocks = static_cast<unsigned>(
      (n + kThreads - 1) / kThreads < 132 * 16 ? (n + kThreads - 1) / kThreads
                                               : 132 * 16);
  if (dtype == 1)
    reduce_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        p.ws, static_cast<bf16*>(y), static_cast<int>(splits), t, p.t_pad, d);
  else
    reduce_kernel<float><<<blocks, kThreads, 0, s>>>(
        p.ws, static_cast<float*>(y), static_cast<int>(splits), t, p.t_pad, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_ffn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
