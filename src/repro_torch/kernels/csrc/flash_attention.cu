// Flash attention for Hopper (sm_90a): online-softmax attention with causal,
// sliding-window and logit-softcap masking, and GQA by head index.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention). It computes what the plain
// version src/repro_torch/kernels/ref.py::attention_ref computes:
//
//   s = (q . k) * sm_scale            f32 scores, scale after the dot
//   s = softcap * tanh(s / softcap)   when softcap is given
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
// Design. One thread block of 4 warps per (query tile of BQ rows, b, h).
// The block walks the K/V tiles of BK rows in order. Tiles wholly above the
// causal diagonal or wholly before the window are skipped; that is exact,
// since their weights would be exactly 0. Each warp owns BQ/4 query rows
// for the whole walk: it computes their scores, their softmax update and
// their share of the accumulator, so only the K/V loads need the block to
// synchronise. In shared memory: the Q tile, one K and one V tile, the
// f32 score tile, the P tile and the f32 output accumulator (BQ x d).
//   bf16: BQ = BK = 64; S = Q K^T and O += P V on the tensor cores
//         (nvcuda::wmma 16x16x16, f32 accumulate). The accumulator lives in
//         shared memory: each warp rescales its rows by alpha, loads them
//         into fragments, adds P V and stores them back. At d = 256 that is
//         185 KB of shared memory, one block per SM.
//   f32:  BQ = BK = 32, scalar f32 FMA (no TF32).
// Ragged Tq and Tk are masked: rows past the end load zeros and are not
// stored.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). At
// gemma2-9b prefill (B 4, P 512, H 16, Hkv 8, d 256, causal) one launch
// needs 4.3 GFLOP of causal products (~4.3 us) and moves 50 MB of q, k, v
// and o (~15 us): bound by bytes. This simple kernel is bound by its
// synchronous shared-memory staging and one block per SM; wgmma, TMA and a
// pipelined K/V ring are later work.
//
// Interface: plain C, loaded with ctypes. The launcher takes device
// pointers, sizes and a stream; launches on that stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

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

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BQ, int BK>
struct Tile {
  static constexpr int kRows = BQ / kWarps;   // query rows per warp
};

// Shared-memory layout, in bytes, for one block.
template <typename T, int BQ, int BK>
__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(T) * (static_cast<size_t>(BQ) * d + 2 * BK * d + BQ * BK)
       + sizeof(float) * (static_cast<size_t>(BQ) * BK + BQ * d + 3 * BQ);
}

// Copy `rows` rows of d elements, row stride `stride` elements, into a
// dense (rows_cap, d) tile; rows past `rows` are zero. d * sizeof(T) is a
// multiple of 16 bytes, so each thread moves 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows,
                                          int rows_cap, int d, size_t stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec_per_row = d / kVec;
  for (int i = threadIdx.x; i < rows_cap * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * d + c) = val;
  }
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int kRows = Tile<BQ, BK>::kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d;
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_k = s_q + BQ * d;
  T* s_v = s_k + BK * d;
  T* s_p = s_v + BK * d;                                   // (BQ, BK)
  float* s_s = reinterpret_cast<float*>(s_p + BQ * BK);    // (BQ, BK)
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
  const T* q = static_cast<const T*>(p.q)
      + (static_cast<size_t>(b) * p.tq + q0) * q_stride + static_cast<size_t>(h) * d;
  const T* kbase = static_cast<const T*>(p.k)
      + static_cast<size_t>(b) * p.tk * k_stride + static_cast<size_t>(kvh) * d;
  const T* vbase = static_cast<const T*>(p.v)
      + static_cast<size_t>(b) * p.tk * k_stride + static_cast<size_t>(kvh) * d;
  const int q_rows = min(BQ, p.tq - q0);

  load_rows<T>(s_q, q, q_rows, BQ, d, q_stride);
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
    load_rows<T>(s_k, kbase + k0 * k_stride, min(BK, p.tk - k0), BK, d,
                 k_stride);
    load_rows<T>(s_v, vbase + k0 * k_stride, min(BK, p.tk - k0), BK, d,
                 k_stride);
    __syncthreads();

    // ---- S = Q K^T for this warp's rows -----------------------------------
    if constexpr (std::is_same<T, bf16>::value) {
      static_assert(kRows == 16, "bf16 path: one 16-row strip per warp");
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, s_q + r0 * d + kk, d);
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, s_k + j * 16 * d + kk, d);
          wmma::mma_sync(acc[j], a, bt, acc[j]);
        }
      }
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(s_s + r0 * BK + j * 16, acc[j], BK,
                                wmma::mem_row_major);
    } else {
      for (int i = lane; i < kRows * BK; i += 32) {
        const int r = r0 + i / BK;
        const int c = i % BK;
        const float* qr = s_q + r * d;
        const float* kr = s_k + c * d;
        float dot = 0.f;
        for (int kk = 0; kk < d; ++kk) dot = fmaf(qr[kk], kr[kk], dot);
        s_s[r * BK + c] = dot;
      }
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
        s_p[r * BK + lane + 32 * j] = from_f32<T>(pv);
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
    if constexpr (std::is_same<T, bf16>::value) {
      for (int n = 0; n < d; n += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, s_acc + r0 * d + n, d, wmma::mem_row_major);
        for (int j = 0; j < BK; j += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(a, s_p + r0 * BK + j, BK);
          wmma::load_matrix_sync(bv, s_v + j * d + n, d);
          wmma::mma_sync(o, a, bv, o);
        }
        wmma::store_matrix_sync(s_acc + r0 * d + n, o, d, wmma::mem_row_major);
      }
    } else {
      for (int i = lane; i < kRows * d; i += 32) {
        const int r = r0 + i / d;
        const int c = i % d;
        const float* pr = s_p + r * BK;
        float acc = s_acc[r * d + c];
        for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], s_v[j * d + c], acc);
        s_acc[r * d + c] = acc;
      }
    }
  }
  __syncthreads();

  // ---- o = acc / l (rows with no valid key: l = 0 -> zeros) ---------------
  T* o = static_cast<T*>(p.o)
      + (static_cast<size_t>(b) * p.tq + q0) * q_stride + static_cast<size_t>(h) * d;
  for (int i = threadIdx.x; i < q_rows * d; i += blockDim.x) {
    const int r = i / d;
    const float l = s_l[r];
    const float denom = l == 0.f ? 1.f : l;
    o[r * q_stride + i % d] = from_f32<T>(s_acc[r * d + i % d] / denom);
  }
}

// Raise the block's dynamic shared memory above 48 KB once per device and
// size, so a launch inside a CUDA-graph capture makes no attribute call.
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

template <typename T, int BQ, int BK>
int launch(const Params& p, int batch, cudaStream_t stream) {
  static int opted_in[64] = {0};
  const size_t smem = smem_bytes<T, BQ, BK>(p.d);
  const long long q_tiles = (p.tq + BQ - 1) / BQ;
  const long long bh = static_cast<long long>(batch) * p.heads;
  if (q_tiles > INT_MAX || bh > 65535 || smem > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = opt_in(flash_kernel<T, BQ, BK>, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(bh));
  flash_kernel<T, BQ, BK><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0: none. has_softcap 0/1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int kv_heads, int tq, int tk, int d, int causal,
    int window, int has_softcap, float softcap, float sm_scale, void* stream) {
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
  if (dtype == 1) return launch<bf16, 64, 64>(p, batch, s);
  if (dtype == 0) return launch<float, 32, 32>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
