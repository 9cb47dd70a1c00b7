// Fused int8 Expansion -> Depthwise -> Projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_dsc.py::
// _fused_dsc_kernel (launched by fused_dsc_pallas). It computes exactly what
// the plain version src/repro_torch/kernels/ref.py::fused_dsc_ref computes,
// bit for bit: one inverted-residual block (without the residual add) over a
// batch of NHWC int8 maps.
//
// Design. One thread block per (image, tile of `tile_rows` output rows):
//   1. the block copies the three weight tensors and its haloed input strip
//      ((tile_rows-1)*s + 3 rows) into shared memory;
//   2. Expansion: int32 dot over C + b_exp, requantized into the F1 strip
//      ((tile_rows-1)*s+3) x (W+2) x M, int8, in shared memory. Every halo
//      position outside the map (row or column) is set to zp_f1 AFTER the
//      expansion, as the oracle pads F1 (not x) with the zero point;
//   3. Depthwise: nine stride-s taps read from the F1 strip, requantized into
//      the F2 tile tile_rows x W2 x M, int8, in shared memory;
//   4. Projection: int32 dot over M, requantized to int8 and written NHWC.
//      The ragged last tile masks its rows; nothing is padded or sliced.
// F1 and F2 never touch device memory: that is the paper's zero-buffer
// dataflow, and the point of fusing the three stages into one launch.
//
// Requantization is round(float32(acc) * m) with round-half-to-even, as
// jnp.round and torch.round do: __int2float_rn, __fmul_rn (no FMA
// contraction) and __float2int_rn. Never roundf, which rounds half away
// from zero.
//
// Bound on this card (H100 SXM: 1,979 TOP/s int8 dense, 3.35 TB/s HBM). At
// the MobileNetV2-VWW shapes (80x80 input, seven blocks, C 8-56, M 48-336),
// batch 256, the seven launches need ~4.06 G int8 ops (2 per MAC), ~2.1 us,
// and move ~19.9 MB of activations (each input read once, each output
// written once), ~5.9 us: every block is bound by bytes, and at these sizes
// mostly by launch latency. The design answers with fusion alone: device
// memory sees only the block's input and output, the halo rows are re-read
// from L2, and the weights (<= 38 KB) are staged once per thread block.
// Tensor-core MMAs, cp.async/TMA and a persistent grid are later work.
//
// Interface: plain C, loaded with ctypes. The launcher takes device
// pointers, ints and a stream; launches on that stream, does not
// synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 9;
constexpr size_t kDefaultSmem = 48 * 1024;

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
  int h, w, cin, cmid, cout, stride, tile_rows;
  int h2, w2, n_tiles, in_rows;
  int zp_f1, zp_f2, zp_out, q6_f1, q6_f2;
};

__device__ __forceinline__ int8_t requant(int acc, float m, int zp, int lo,
                                          int hi) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(acc), m)) + zp;
  return static_cast<int8_t>(min(max(q, lo), hi));
}

size_t smem_bytes(const Params& p) {
  return static_cast<size_t>(p.cin) * p.cmid        // w_exp
       + static_cast<size_t>(kTaps) * p.cmid        // w_dw9
       + static_cast<size_t>(p.cmid) * p.cout       // w_proj
       + static_cast<size_t>(p.in_rows) * p.w * p.cin         // x strip
       + static_cast<size_t>(p.in_rows) * (p.w + 2) * p.cmid  // F1 strip
       + static_cast<size_t>(p.tile_rows) * p.w2 * p.cmid;    // F2 tile
}

__global__ void __launch_bounds__(kThreads) fused_dsc_kernel(const Params p) {
  extern __shared__ int8_t smem[];
  const int tile = blockIdx.x % p.n_tiles;
  const int img = blockIdx.x / p.n_tiles;
  const int wp = p.w + 2;                      // F1 columns incl. halo
  const int s = p.stride;

  int8_t* s_wexp = smem;
  int8_t* s_wdw = s_wexp + p.cin * p.cmid;
  int8_t* s_wproj = s_wdw + kTaps * p.cmid;
  int8_t* s_x = s_wproj + p.cmid * p.cout;
  int8_t* s_f1 = s_x + p.in_rows * p.w * p.cin;
  int8_t* s_f2 = s_f1 + p.in_rows * wp * p.cmid;

  const int row0 = tile * p.tile_rows;         // first output row
  const int rows = min(p.tile_rows, p.h2 - row0);   // ragged last tile
  const int strip_rows = (rows - 1) * s + 3;   // F1 rows this tile reads
  const int r0 = row0 * s - 1;                 // x row of strip row 0
  const int row_elems = p.w * p.cin;
  const int8_t* x_img = p.x + static_cast<size_t>(img) * p.h * row_elems;

  // ---- 1. weights and the input strip into shared memory -----------------
  for (int i = threadIdx.x; i < p.cin * p.cmid; i += blockDim.x)
    s_wexp[i] = p.w_exp[i];
  for (int i = threadIdx.x; i < kTaps * p.cmid; i += blockDim.x)
    s_wdw[i] = p.w_dw9[i];
  for (int i = threadIdx.x; i < p.cmid * p.cout; i += blockDim.x)
    s_wproj[i] = p.w_proj[i];
  for (int i = threadIdx.x; i < strip_rows * row_elems; i += blockDim.x) {
    const int gr = r0 + i / row_elems;
    if (gr >= 0 && gr < p.h)
      s_x[i] = x_img[static_cast<size_t>(gr) * row_elems + i % row_elems];
  }
  __syncthreads();

  // ---- 2. Expansion -> F1 strip; out-of-map halo = zp_f1 -----------------
  for (int i = threadIdx.x; i < strip_rows * wp * p.cmid; i += blockDim.x) {
    const int m = i % p.cmid;
    const int pc = (i / p.cmid) % wp;
    const int r = i / (p.cmid * wp);
    const int gr = r0 + r;
    const int c = pc - 1;
    int8_t v = static_cast<int8_t>(p.zp_f1);
    if (gr >= 0 && gr < p.h && c >= 0 && c < p.w) {
      const int8_t* xv = s_x + (r * p.w + c) * p.cin;
      int acc = __ldg(p.b_exp + m);
      for (int k = 0; k < p.cin; ++k)
        acc += static_cast<int>(xv[k]) * static_cast<int>(s_wexp[k * p.cmid + m]);
      v = requant(acc, __ldg(p.m_exp + m), p.zp_f1, p.zp_f1, p.q6_f1);
    }
    s_f1[i] = v;
  }
  __syncthreads();

  // ---- 3. Depthwise: nine stride-s taps -> F2 tile -----------------------
  for (int i = threadIdx.x; i < rows * p.w2 * p.cmid; i += blockDim.x) {
    const int m = i % p.cmid;
    const int c2 = (i / p.cmid) % p.w2;
    const int tr = i / (p.cmid * p.w2);
    int acc = __ldg(p.b_dw + m);
    for (int dy = 0; dy < 3; ++dy) {
      const int8_t* f1_row = s_f1 + ((tr * s + dy) * wp + c2 * s) * p.cmid + m;
      for (int dx = 0; dx < 3; ++dx)
        acc += static_cast<int>(f1_row[dx * p.cmid])
             * static_cast<int>(s_wdw[(dy * 3 + dx) * p.cmid + m]);
    }
    s_f2[i] = requant(acc, __ldg(p.m_dw + m), p.zp_f2, p.zp_f2, p.q6_f2);
  }
  __syncthreads();

  // ---- 4. Projection -> int8 NHWC output (valid rows only) ---------------
  int8_t* out_tile = p.out
      + (static_cast<size_t>(img) * p.h2 + row0) * p.w2 * p.cout;
  for (int i = threadIdx.x; i < rows * p.w2 * p.cout; i += blockDim.x) {
    const int n = i % p.cout;
    const int8_t* f2v = s_f2 + (i / p.cout) * p.cmid;
    int acc = __ldg(p.b_proj + n);
    for (int m = 0; m < p.cmid; ++m)
      acc += static_cast<int>(f2v[m]) * static_cast<int>(s_wproj[m * p.cout + n]);
    out_tile[i] = requant(acc, __ldg(p.m_proj + n), p.zp_out, -128, 127);
  }
}

}  // namespace

extern "C" int fused_dsc_launch(
    const void* x, const void* w_exp, const void* w_dw9, const void* w_proj,
    const void* b_exp, const void* b_dw, const void* b_proj,
    const void* m_exp, const void* m_dw, const void* m_proj, void* out,
    int batch, int h, int w, int cin, int cmid, int cout, int stride,
    int tile_rows, int zp_f1, int zp_f2, int zp_out, int q6_f1, int q6_f2,
    void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cmid <= 0 || cout <= 0 ||
      (stride != 1 && stride != 2) || tile_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.stride = stride; p.tile_rows = tile_rows;
  p.h2 = (h + stride - 1) / stride;
  p.w2 = (w + stride - 1) / stride;
  p.n_tiles = (p.h2 + tile_rows - 1) / tile_rows;
  p.in_rows = (tile_rows - 1) * stride + 3;
  p.zp_f1 = zp_f1; p.zp_f2 = zp_f2; p.zp_out = zp_out;
  p.q6_f1 = q6_f1; p.q6_f2 = q6_f2;

  const long long blocks = static_cast<long long>(batch) * p.n_tiles;
  const size_t smem = smem_bytes(p);
  if (blocks > INT_MAX || smem > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    // Above 48 KB only as opted-in dynamic shared memory; a size beyond the
    // card's limit makes this call fail, and the launch is not attempted.
    // The opt-in is raised once per device and size, so a launch inside a
    // CUDA-graph capture makes no attribute call.
    static int opted_in[64] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= 64 || static_cast<int>(smem) > opted_in[dev]) {
      e = cudaFuncSetAttribute(fused_dsc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev >= 0 && dev < 64) opted_in[dev] = static_cast<int>(smem);
    }
  }
  fused_dsc_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_dsc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
