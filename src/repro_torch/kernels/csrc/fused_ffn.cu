// Fused gated FFN for Hopper (sm_90a): y = act(x Wg) * (x Wu) @ Wd, with the
// (T, d_ff) intermediate h kept on chip.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ffn.py::
// _fused_ffn_kernel (launched by fused_ffn_pallas). It computes what the
// plain version src/repro_torch/kernels/ref.py::fused_ffn_ref computes:
// f32 accumulation of both expansions, h = act(g) * u in f32, h cast to x's
// type before the down projection, f32 accumulation of the projection, the
// output cast to x's type. Ungated (no Wg): h = act(x Wu).
//
// bf16 design (the serving path): output-stationary over a thread-block
// cluster, as the Pallas kernel is output-stationary over its sequential
// d_ff grid axis. Its (block_t, d_model) f32 accumulator does not fit one
// block at d_model 3584 (917 KB at 64 rows), so a cluster of C blocks
// splits it by d_model columns: each block holds 64 rows x 2 NW columns in
// the registers of two consumer warpgroups (NW columns each; C 8 and NW 224
// at gemma2-9b, 112 f32 registers per thread; NW 256 at glm4-9b's 4096,
// 128). The grid is (C, token tiles of 64 rows, d_ff groups), the cluster
// (C, 1, 1). Each block walks its group's d_ff in chunks of C x 64 columns:
//   1. expansion: the block computes its own 64-column piece of g and u with
//      wgmma m64n64k16 over K = d_model (each warpgroup 32 columns of g and
//      the same 32 of u in one instruction: Wg's and Wu's 32-column boxes
//      side by side as two atoms of the 64-byte swizzle, B MN-major), 128
//      columns of d_model per ring stage.
//   2. mix in f32, h = act(g) * u, cast to bf16, and all-gather over the
//      cluster through distributed shared memory: after a quad transpose
//      each thread pushes 16-byte rows of its piece into the chunk buffer of
//      every block (128-byte swizzle, K-major: the A layout of the
//      projection) with st.async, whose bytes complete a transaction count
//      on the receiving block's h_full barrier. A block pushes chunk c + 1
//      only after every block's projection of chunk c has read its buffer
//      (the h_free barrier, one arrive per consumer warp of the cluster), so
//      one buffer of C x 8 KB suffices and the next chunk's expansion
//      overlaps the peers' projection.
//   3. projection: acc += h_chunk (64 x C*64) @ Wd[chunk rows, the block's
//      columns], wgmma m64n{NW}k16, Wd through the same ring in 32-row
//      stages.
// A producer warpgroup keeps the ring full (one thread issues every TMA
// load) and gives its registers to the two consumer warpgroups (setmaxnreg
// 40 / 232). The consumers release a stage once the wgmma that read it has
// retired (wgmma.wait_group 1 keeps one stage's products in flight).
// Epilogue: each block casts its accumulator to bf16 and writes its (64,
// 2 NW) slice of y. Each output element is summed by one thread in a fixed
// d_ff order: no workspace, no second pass. At decode (one token tile) one
// cluster cannot pull the weights fast enough, so the plan splits d_ff into
// groups (14 at gemma2-9b T 4: 112 blocks); each group writes an f32
// partial of (T, d_model), and reduce_kernel sums the groups in a fixed
// order (0.8 MB at T 4, 0.26% of the 308 MB the launch reads). At prefill
// the token tiles' clusters fill the card, `resident` at a time (the caller
// reads it from the card: fused_ffn_max_clusters), and the launch takes
// whole waves of them: the plan also cuts d_ff into up to 4 groups where
// that saves a tenth of the waves x chunks a cluster walks (glm4-9b at T
// 1500, 15 resident: 24 clusters of 27 chunks in 2 waves, 54; 3 groups, 72
// clusters of 9 in 5 waves, 45).
// One cluster covers 8 x 2 x 256 = 4096 columns; NW 256 is taken only at C
// 8, where 224 does not cover (3585 to 4096 columns), so every plan at
// d_model <= 3584 is the 224-wide one. Wider, the plan cuts d_model into S
// slices of at most 4096 columns, S = ceil(d_model / 4096): 2 at 5120
// (qwen3-14b, llama4; NW 224) and 8192 (qwen2-72b; NW 256). The grid's x is
// C x S: block x holds columns [x * 2 NW, (x + 1) * 2 NW), so slice x / C's
// cluster walks the same d_ff chunks as the others and recomputes their
// expansion. h still never leaves a cluster, and each output element is
// still summed by one thread in d_ff order. What that pays: the expansion
// (4/6 of the gated FFN's operations) runs S times, and the projection also
// runs over the last slice's columns past d_model (5120: 7168 columns), so
// 1.80x the operations at 5120 and 1.67x at 8192; at decode the S slices
// each read Wg and Wu (through L2 where they run together). A cluster of
// 16 is not portable and its residency unknown; an f32 accumulator in
// shared memory takes 2 MB per 64-row tile at 8192.
// Ragged T, d_ff and d_model are zero-filled by the tensor maps: a zero
// weight column gives h = act(0) * 0 = 0 (gated) or act(0) = 0 (ungated,
// every act here). Stores past T or d_model are masked.
// f32 design (tests and the f32 checks, not the serving path): scalar f32
// FMA (no TF32), 16 token rows per block, d_ff split over blocks with f32
// partials in a workspace and the same fixed-order reduce_kernel.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). At
// glm4-9b (d_model 4096, d_ff 13696) prefill, T = 1500, one launch is 0.505
// TFLOP (0.51 ms) and reads 0.34 GB of weights (0.10 ms): bound by
// operations. What this design leaves in the way (PERF.md): a cluster walks
// a chunk in about the same time whether 1 or 15 clusters run, so the time
// is the waves' (15 clusters of 8 resident; T 960 and T 1024 differ by 2x);
// within a cluster the per-stage handshake with small (n64) expansion
// products keeps the tensor cores under half busy. The bytes from L2 into
// shared memory are not the bound: each cluster streams all the weights
// (10.4 GB a launch at T 1500), and loading each x box once per cluster
// with TMA multicast (8.5 GB) ran no faster. At decode, T = 4, it reads
// the 337 MB of weights (0.10 ms): bound by bytes.
//
// kernels/fused_ffn.py::plan decides each launch (cluster, columns, chunk,
// ring stages, groups, shared memory, grid, workspace). The launcher takes
// its 13 numbers and decides nothing itself: check_plan below refuses a plan
// the kernel cannot run safely or completely.
//
// Interface: plain C, loaded with ctypes. The launcher takes device
// pointers (the workspace is allocated by the caller), sizes, the plan and
// a stream; launches on that stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() (or kEncodeFailed / kNoCluster /
// kBadPlan).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNoCluster = -2;   // no cluster of this launch fits the device
constexpr int kBadPlan = -3;     // a handed plan the kernel cannot run
int g_cluster_size = 0;          // the refused launch, for the error string
int g_cluster_smem = 0;
const char* g_refusal = "";      // which check refused the plan

enum Act { kSilu = 0, kGelu = 1, kReluSq = 2, kRelu = 3 };

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

// y[t, n] = sum over groups of ws[g, t, n], in group order, cast to T.
template <typename T>
__global__ void __launch_bounds__(256) reduce_kernel(
    const float* ws, T* y, int groups, int t, int t_pad, int d) {
  const size_t n = static_cast<size_t>(t) * d;
  const size_t slice = static_cast<size_t>(t_pad) * d;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += ws[k * slice + i];
    if constexpr (sizeof(T) == 2) y[i] = __float2bfloat16_rn(s);
    else y[i] = s;
  }
}

template <typename T>
void launch_reduce(const float* ws, void* y, int groups, int t, int t_pad,
                   int d, cudaStream_t s) {
  const size_t n = static_cast<size_t>(t) * d;
  const unsigned blocks = static_cast<unsigned>(
      (n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  reduce_kernel<T><<<blocks, 256, 0, s>>>(ws, static_cast<T*>(y), groups, t,
                                          t_pad, d);
}

// ===========================================================================
// The check of a handed plan (kernels/fused_ffn.py::plan decides it)
// ===========================================================================

constexpr int kBT = 64;            // bf16: token rows per block (wgmma M)
constexpr int kPiece = 64;         // d_ff columns of h per block per chunk
constexpr int kHalf = 32;          // ... per consumer warpgroup
constexpr int kExpK = 128;         // d_model columns per expansion stage
constexpr int kProjK = 32;         // d_ff rows per projection stage
constexpr int kAtom = 32;          // bf16 columns of one 64-byte-swizzle box
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreadsBf16 = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer gives up
constexpr int kConsumerRegs = 232;  // registers to the consumers
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;              // opt-in limit per block
constexpr int kXCols = 64;          // bf16 columns of one 128-byte-swizzle box
constexpr int kXBoxes = kExpK / kXCols;         // x boxes per stage
constexpr uint32_t kXBox = kBT * kXCols * 2;    // x box: 8 KB
constexpr uint32_t kWBox = kExpK * kAtom * 2;   // Wg / Wu box: 8 KB
constexpr uint32_t kDBox = kProjK * kAtom * 2;  // Wd box: 2 KB
constexpr uint32_t kHPiece = kBT * kPiece * 2;  // one block's h piece: 8 KB
constexpr int kBarBytes = 8 * (2 * kMaxStages + 2);
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxWidth = 256;      // wgmma's widest N: a full cluster only

constexpr int kF32BT = 16;          // f32: token rows per block
constexpr int kF32Threads = 256;
constexpr int kF32Cols = 128;       // d_ff / d_model columns per sub-block
constexpr int kF32K = 32;           // k-step of the staged x

// Bytes of one ring stage: an expansion stage (two x boxes, two Wg and two
// Wu boxes) or a projection stage (32 rows of Wd x 2 NW columns).
__host__ __device__ constexpr uint32_t slot_bytes(int nw) {
  return kXBoxes * kXBox + 4 * kWBox > static_cast<uint32_t>(kProjK * 4 * nw)
             ? kXBoxes * kXBox + 4 * kWBox
             : static_cast<uint32_t>(kProjK * 4 * nw);
}

// A launch: the 13 numbers of kernels/fused_ffn.py::Plan, in its order.
struct LaunchPlan {
  int block_t, cluster, cols, chunk, stages, groups, per_group, chunks;
  long long smem, grid_x, grid_y, grid_z, ws_bytes;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The widths (output columns per consumer warpgroup) launch_bf16 is
// instantiated for.
bool is_width(int nw) {
  return nw == 32 || nw == 64 || nw == 128 || nw == 224 || nw == kMaxWidth;
}

// The bf16 kernel's shared memory: 1 KB of alignment slack, the ring, one
// chunk of h (a piece per block of the cluster), the barriers.
long long bf16_smem(int nw, int cluster, int stages) {
  return 1024 + static_cast<long long>(stages) * slot_bytes(nw)
       + static_cast<long long>(cluster) * kHPiece + kBarBytes;
}

int refuse(const char* why) {
  g_refusal = why;
  return kBadPlan;
}

// 0 if the kernel runs `pl` for dtype (0 f32, 1 bf16), x (t, d) and d_ff f
// safely and completely; else kBadPlan, with g_refusal naming the check.
int check_plan(int dtype, int t, int d, int f, const LaunchPlan& pl) {
  if (pl.grid_y > 65535 || pl.grid_z > 65535)
    return refuse("grid y or z over 65535");
  if (pl.per_group < 1 || pl.groups != cdiv(pl.chunks, pl.per_group))
    return refuse("groups of per_group chunks do not cover the chunks");
  long long ws = 0;   // f32 partials of the groups
  if (dtype == 1) {
    const int c = pl.cluster, nw = pl.cols / 2;
    if (pl.block_t != kBT) return refuse("block_t is not 64");
    if (c != 1 && c != 2 && c != 4 && c != kMaxCluster)
      return refuse("cluster is not 1, 2, 4 or 8");
    if (pl.cols % 2 || !is_width(nw))
      return refuse("cols / 2 is not 32, 64, 128, 224 or 256");
    if (nw == kMaxWidth && c != kMaxCluster)
      return refuse("256 columns a warpgroup below a full cluster of 8");
    if (pl.grid_x % c || pl.grid_x * pl.cols < d)
      return refuse("grid x is not whole clusters whose slices cover "
                    "d_model");
    if (pl.chunk != c * kPiece) return refuse("chunk != cluster * 64");
    if (pl.chunks != cdiv(f, pl.chunk))
      return refuse("chunks of chunk columns do not cover d_ff");
    if (pl.grid_y != cdiv(t, kBT) || pl.grid_z != pl.groups)
      return refuse("grid y, z are not the token tiles and the groups");
    if (pl.stages < 2 || pl.stages > kMaxStages)
      return refuse("stages outside [2, 6]");
    if (pl.smem != bf16_smem(nw, c, pl.stages) || pl.smem > kSmemLimit)
      return refuse("smem is not the kernel's for its width, cluster and "
                    "stages, or over 232448 bytes");
    if (pl.groups > 1) ws = 4LL * pl.groups * t * d;
  } else {
    if (pl.block_t != kF32BT || pl.cluster != 1 || pl.cols != d ||
        pl.stages != 0)
      return refuse("block_t, cluster, cols, stages are not the f32 "
                    "kernel's 16, 1, d_model, 0");
    if (pl.chunk != pl.per_group * kF32Cols)
      return refuse("chunk != per_group * 128");
    if (pl.chunks != cdiv(f, kF32Cols))
      return refuse("chunks of 128 columns do not cover d_ff");
    if (pl.grid_x != cdiv(t, kF32BT) || pl.grid_y != pl.groups ||
        pl.grid_z != 1)
      return refuse("grid is not the token tiles and the d_ff splits");
    if (pl.smem != 4LL * kF32BT * (pl.chunk + kF32K) || pl.smem > kSmemLimit)
      return refuse("smem is not the f32 kernel's for its chunk, or over "
                    "232448 bytes");
    ws = 4LL * pl.groups * pl.grid_x * kF32BT * d;
  }
  if (pl.ws_bytes < ws)
    return refuse("ws_bytes below the groups' f32 partials");
  return 0;
}

// ===========================================================================
// bf16: wgmma over a thread-block cluster, TMA ring, h all-gathered in DSMEM
// ===========================================================================

// acc (64 x N, f32) += A (64 x 16, bf16 K-major, 128-byte swizzle) . B (16 x
// N, bf16 MN-major, 64-byte swizzle: the transpose bit is set). PTX names
// every accumulator register.
template <int N>
__device__ __forceinline__ void wgmma_mn(float* d, uint64_t desc_a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_mn<32>(float* d, uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_mn<64>(float* d, uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_mn<128>(float* d, uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_mn<224>(float* d, uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 1;\n}\n"
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
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_mn<256>(float* d, uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// A 4 x 4 transpose over the four threads of a quad: thread i's v[j]
// becomes thread j's v[i] (two butterfly steps of shuffles and selects).
__device__ __forceinline__ void transpose_quad(uint32_t (&v)[4], int cq) {
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {
    const bool hi = (cq & m) != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j & m) continue;
      const uint32_t send = hi ? v[j] : v[j | m];
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, m);
      if (hi) v[j] = got;
      else v[j | m] = got;
    }
  }
}

struct Bf16Params {
  void* y;         // (T, d_model) bf16, when groups == 1
  float* ws;       // (groups, T, d_model) f32 partials, when groups > 1
  int t, d, act, gated, cluster;
  int stages, per_group, chunks;
};

// Accumulator layout (wgmma m64nNk16, f32): thread (warp w of its
// warpgroup, lane 4g + c) holds, for each 8-column block j, rows 16w + g
// (registers 4j, 4j + 1) and 16w + g + 8 (4j + 2, 4j + 3) at columns
// 8j + 2c and 8j + 2c + 1.
template <int NW>
__global__ void __launch_bounds__(kThreadsBf16, 1) ffn_wgmma_kernel(
    const Bf16Params p, const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_wg,
    const __grid_constant__ CUtensorMap tm_wu,
    const __grid_constant__ CUtensorMap tm_wd) {
  constexpr uint32_t kSlot = slot_bytes(NW);
  constexpr int kDAtoms = 2 * NW / kAtom;        // Wd boxes per stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n_stages = p.stages;
  const int cluster = p.cluster;   // cluster (C, 1, 1); grid x: C x slices
  const uint32_t h_buf = base + n_stages * kSlot;    // one chunk of h
  const uint32_t bars = h_buf + cluster * kHPiece;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (n_stages + s); };
  const uint32_t h_full = bars + 8 * (2 * n_stages);       // h gathered
  const uint32_t h_free = bars + 8 * (2 * n_stages + 1);   // h read

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int t0 = blockIdx.y * kBT;
  const int c_begin = blockIdx.z * p.per_group;
  const int c_end = min(p.chunks, c_begin + p.per_group);
  // this block's columns: slice blockIdx.x / C, rank blockIdx.x % C
  const int col0 = static_cast<int>(blockIdx.x) * 2 * NW;
  const int exp_stages = (p.d + kExpK - 1) / kExpK;
  const int proj_stages = cluster * kPiece / kProjK;

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(h_full, 1);   // one expect_tx; the bytes come by st.async
    mbar_init(h_free, kConsumerWarps * cluster);
    mbar_fence_init();
  }
  cluster_sync();   // every block's barriers exist before any remote arrive

  if (tid >= kConsumers) {
    // ---- producer: one thread issues every TMA load, in consumption order
    setmaxnreg_dec<kProducerRegs>();
    if (tid != kConsumers) return;
    int it = 0;
    for (int c = c_begin; c < c_end; ++c) {
      const int fc = c * cluster * kPiece;   // the chunk's first d_ff column
      const int fb = fc + static_cast<int>(rank) * kPiece;   // this piece
      for (int ks = 0; ks < exp_stages; ++ks, ++it) {
        const int slot = it % n_stages;
        mbar_wait(empty(slot), ((it / n_stages) & 1) ^ 1);
        const uint32_t s = base + slot * kSlot;
        mbar_expect_tx(full(slot),
                       kXBoxes * kXBox + (p.gated ? 4 : 2) * kWBox);
#pragma unroll
        for (int b = 0; b < kXBoxes; ++b)
          tma_load_2d(s + b * kXBox, &tm_x, full(slot),
                      ks * kExpK + b * kXCols, t0);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const uint32_t sw = s + kXBoxes * kXBox + w * 2 * kWBox;
          // ungated: Wu goes where Wg would, and only g is read
          if (p.gated) {
            tma_load_2d(sw, &tm_wg, full(slot), fb + w * kHalf, ks * kExpK);
            tma_load_2d(sw + kWBox, &tm_wu, full(slot), fb + w * kHalf,
                        ks * kExpK);
          } else {
            tma_load_2d(sw, &tm_wu, full(slot), fb + w * kHalf, ks * kExpK);
          }
        }
      }
      for (int kp = 0; kp < proj_stages; ++kp, ++it) {
        const int slot = it % n_stages;
        mbar_wait(empty(slot), ((it / n_stages) & 1) ^ 1);
        const uint32_t s = base + slot * kSlot;
        mbar_expect_tx(full(slot), kDAtoms * kDBox);
        for (int a = 0; a < kDAtoms; ++a)
          tma_load_2d(s + a * kDBox, &tm_wd, full(slot), col0 + a * kAtom,
                      fc + kp * kProjK);
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, NW output columns each -------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int cq = tid % 4;
  const int r0 = warp * 16 + g;   // this thread's rows: r0 and r0 + 8
  // A stage is free once every consumer warp is done with it.
  auto release = [&](int slot) {
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty(slot));
  };
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int ci = 0; ci < c_end - c_begin; ++ci) {
    // 1. expansion: [g | u] (64 x 64) for this warpgroup's 32 columns
    float gu[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gu[i] = 0.f;
    for (int ks = 0; ks < exp_stages; ++ks, ++it) {
      const int slot = it % n_stages;
      mbar_wait(full(slot), (it / n_stages) & 1);
      const uint32_t s = base + slot * kSlot;
      const uint32_t sw = s + kXBoxes * kXBox + wg * 2 * kWBox;
      fence_regs<32>(gu);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kExpK / 16; ++kk)   // A: x box kk / 4, 32 B each
        wgmma_mn<64>(gu,
                     smem_desc(s + (kk / 4) * kXBox + (kk % 4) * 32, 16, 1024,
                               kSwizzle128),
                     smem_desc(sw + kk * 1024, kWBox, 512, kSwizzle64));
      wgmma_commit();
      fence_regs<32>(gu);
      wgmma_wait<1>();   // the previous stage's products have retired
      if (ks > 0) release((it - 1) % n_stages);
    }
    wgmma_wait<0>();
    fence_regs<32>(gu);
    release((it - 1) % n_stages);

    // 2. h = act(g) * u in f32, bf16, pushed into every block's buffer.
    // hv[half][j]: row r0 + 8 half, columns 8j + 2cq and 8j + 2cq + 1.
    uint32_t hv[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 4 * j + 2 * half;
        float h0 = act_fn(gu[e], p.act), h1 = act_fn(gu[e + 1], p.act);
        if (p.gated) {
          h0 *= gu[16 + e];
          h1 *= gu[16 + e + 1];
        }
        hv[half][j] = pack_bf16(h0, h1);
      }
    }
    // Transpose over the quad: thread cq then holds 8-column block j = cq
    // (16 bytes) of each of its two rows.
#pragma unroll
    for (int half = 0; half < 2; ++half) transpose_quad(hv[half], cq);
    // every block's projection of the previous chunk is done with h
    if (ci > 0) mbar_wait(h_free, (ci - 1) & 1);
    if (tid == 0) mbar_expect_tx(h_full, cluster * kHPiece);
    const int col = wg * kHalf + 8 * cq;   // column in the piece
    const uint32_t piece = h_buf + rank * kHPiece;
    for (int q = 0; q < cluster; ++q) {
      const uint32_t bar = map_to_rank(h_full, q);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        const uint32_t off = row * 128 + (((col >> 3) ^ (row & 7)) << 4);
        st_async_v4(map_to_rank(piece + off, q), hv[half], bar);
      }
    }
    mbar_wait_cluster(h_full, ci & 1);
    fence_proxy_async();

    // 3. projection: acc += h (64 x C*64) . Wd[chunk rows, NW columns]
    for (int kp = 0; kp < proj_stages; ++kp, ++it) {
      const int slot = it % n_stages;
      mbar_wait(full(slot), (it / n_stages) & 1);
      const uint32_t s = base + slot * kSlot + wg * (NW / kAtom) * kDBox;
      fence_regs<NW / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kProjK / 16; ++kk) {
        const int k = kp * kProjK + kk * 16;
        wgmma_mn<NW>(acc,
                     smem_desc(h_buf + (k / kPiece) * kHPiece
                                   + (k % kPiece) / 16 * 32,
                               16, 1024, kSwizzle128),
                     smem_desc(s + kk * 1024, kDBox, 512, kSwizzle64));
      }
      wgmma_commit();
      fence_regs<NW / 2>(acc);
      wgmma_wait<1>();
      if (kp > 0) release((it - 1) % n_stages);
    }
    wgmma_wait<0>();
    fence_regs<NW / 2>(acc);
    release((it - 1) % n_stages);
    // this warp is done reading h; after the last chunk no block writes it
    if (ci + 1 < c_end - c_begin) {
      __syncwarp();
      if (tid % 32 == 0)
        for (int q = 0; q < cluster; ++q)
          mbar_arrive_remote(map_to_rank(h_free, q));
    }
  }

  // ---- epilogue: this block's (64, 2 NW) slice, bf16 y or an f32 partial
  const int nb = col0 + wg * NW;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + r0 + 8 * half;
    if (row >= p.t) continue;
    if (p.ws != nullptr) {
      float* out = p.ws + (static_cast<size_t>(blockIdx.z) * p.t + row) * p.d;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int n = nb + 8 * j + 2 * cq;
        if (n < p.d)
          *reinterpret_cast<float2*>(out + n) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    } else {
      bf16* out = static_cast<bf16*>(p.y) + static_cast<size_t>(row) * p.d;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int n = nb + 8 * j + 2 * cq;
        if (n < p.d)
          *reinterpret_cast<uint32_t*>(out + n) =
              pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// The cluster launch of a plan: grid, 384 threads, the plan's shared
// memory, cluster (C, 1, 1).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(const LaunchPlan& pl, cudaStream_t stream) {
    cfg.gridDim = dim3(static_cast<unsigned>(pl.grid_x),
                       static_cast<unsigned>(pl.grid_y),
                       static_cast<unsigned>(pl.grid_z));
    cfg.blockDim = dim3(kThreadsBf16, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(pl.cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Opt the kernel into the plan's shared memory, once per device and size,
// and count how many of its clusters can be resident at once.
template <int NW>
cudaError_t max_clusters(const LaunchPlan& pl, int* n) {
  static int opted_in[64] = {0};
  cudaError_t e = opt_in(ffn_wgmma_kernel<NW>, static_cast<size_t>(pl.smem),
                         opted_in);
  if (e != cudaSuccess) return e;
  ClusterLaunch launch(pl, nullptr);
  return cudaOccupancyMaxActiveClusters(n, ffn_wgmma_kernel<NW>, &launch.cfg);
}

template <int NW>
int launch_bf16(const LaunchPlan& pl, const Bf16Params& p, const void* x,
                const void* wg, const void* wu, const void* wd, int f,
                cudaStream_t stream) {
  static int checked[64][4] = {{0}};   // smem whose cluster fits, per C
  EncodeTiled fn = nullptr;
  cudaError_t e = encode_tiled(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_x, tm_g, tm_u, tm_d;
  int r = encode_2d(fn, &tm_x, x, p.t, p.d, kXCols, kBT,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == 0)
    r = encode_2d(fn, &tm_u, wu, p.d, f, kAtom, kExpK,
                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (r == 0 && wg != nullptr)
    r = encode_2d(fn, &tm_g, wg, p.d, f, kAtom, kExpK,
                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (r == 0)
    r = encode_2d(fn, &tm_d, wd, f, p.d, kAtom, kProjK,
                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (r != 0) return r;
  if (wg == nullptr) tm_g = tm_u;

  // Once per device and size (outside any graph capture, as the first call
  // is): the shared-memory opt-in, and a cluster of this launch must fit.
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ci = 0;
  while ((1 << ci) < pl.cluster) ++ci;
  if (dev < 0 || dev >= 64 || checked[dev][ci] < pl.smem) {
    int n_clusters = 0;
    e = max_clusters<NW>(pl, &n_clusters);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters < 1) {
      g_cluster_size = pl.cluster;
      g_cluster_smem = static_cast<int>(pl.smem);
      return kNoCluster;
    }
    if (dev >= 0 && dev < 64) checked[dev][ci] = static_cast<int>(pl.smem);
  }
  ClusterLaunch launch(pl, stream);
  e = cudaLaunchKernelEx(&launch.cfg, ffn_wgmma_kernel<NW>, p, tm_x, tm_g,
                         tm_u, tm_d);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pl.groups > 1)
    launch_reduce<bf16>(p.ws, p.y, pl.groups, p.t, p.t, p.d, stream);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// f32: scalar path (tests and the f32 checks)
// ===========================================================================

struct F32Params {
  const float* x;
  const float* wg;     // (D, F) or null (ungated)
  const float* wu;     // (D, F)
  const float* wd;     // (F, D)
  float* ws;           // (splits, T_pad, D) f32 partials
  int t, d, f, fr, t_pad, act;
};

// 16 token rows per block; each thread owns one column of a 128-column block
// and 8 of the 16 rows. Scalar FMA, x staged through shared memory.
__global__ void __launch_bounds__(kF32Threads)
ffn_f32_kernel(const F32Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);       // (BT, FR)
  float* s_x = s_h + kF32BT * p.fr;                  // (BT, kF32K)
  const int col = threadIdx.x % kF32Cols;
  const int row0 = threadIdx.x / kF32Cols;           // 0 or 1; rows row0 + 2i
  constexpr int kR = kF32BT * kF32Cols / kF32Threads;   // 8 rows per thread
  const int t0 = blockIdx.x * kF32BT;
  const int split = blockIdx.y;
  const int f0 = split * p.fr;
  const int f_len = min(p.fr, p.f - f0);
  const bool gated = p.wg != nullptr;

  for (int fb = 0; fb < f_len; fb += kF32Cols) {
    const int fc = f0 + fb + col;
    const bool in = fb + col < f_len;
    float g[kR], u[kR];
    for (int i = 0; i < kR; ++i) g[i] = u[i] = 0.f;
    for (int k0 = 0; k0 < p.d; k0 += kF32K) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32BT * kF32K; i += blockDim.x) {
        const int r = i / kF32K, c = k0 + i % kF32K;
        s_x[i] = (t0 + r < p.t && c < p.d)
                     ? p.x[static_cast<size_t>(t0 + r) * p.d + c] : 0.f;
      }
      __syncthreads();
      if (!in) continue;
      for (int kk = 0; kk < kF32K && k0 + kk < p.d; ++kk) {
        const size_t w_off = static_cast<size_t>(k0 + kk) * p.f + fc;
        const float wuv = p.wu[w_off];
        const float wgv = gated ? p.wg[w_off] : 0.f;
        for (int i = 0; i < kR; ++i) {
          const float xv = s_x[(row0 + 2 * i) * kF32K + kk];
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
  for (int nb = 0; nb < p.d; nb += kF32Cols) {
    const int n = nb + col;
    if (n >= p.d) continue;
    float acc[kR];
    for (int i = 0; i < kR; ++i) acc[i] = 0.f;
    for (int j = 0; j < f_len; ++j) {
      const float w = p.wd[static_cast<size_t>(f0 + j) * p.d + n];
      for (int i = 0; i < kR; ++i)
        acc[i] = fmaf(s_h[(row0 + 2 * i) * p.fr + j], w, acc[i]);
    }
    for (int i = 0; i < kR; ++i)
      ws[static_cast<size_t>(row0 + 2 * i) * p.d + n] = acc[i];
  }
}

int launch_f32(const LaunchPlan& pl, const F32Params& p, void* y,
               cudaStream_t s) {
  static int opted_in[64] = {0};
  cudaError_t e = opt_in(ffn_f32_kernel, static_cast<size_t>(pl.smem), opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(pl.grid_x),
                  static_cast<unsigned>(pl.grid_y));
  ffn_f32_kernel<<<grid, kF32Threads, static_cast<size_t>(pl.smem), s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  launch_reduce<float>(p.ws, y, pl.groups, p.t, p.t_pad, p.d, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wg null: ungated. act: 0 silu, 1 gelu
// (tanh), 2 relu_sq, 3 relu. The plan: kernels/fused_ffn.py::Plan's 13
// numbers; ws holds its ws_bytes (null when 0).
extern "C" int fused_ffn_launch(
    const void* x, const void* wg, const void* wu, const void* wd, void* ws,
    void* y, int dtype, int t, int d, int f, int act, int block_t,
    int cluster, int cols, int chunk, int stages, int groups, int per_group,
    int chunks, int smem, int grid_x, int grid_y, int grid_z,
    long long ws_bytes, void* stream) {
  if (t <= 0 || d <= 0 || f <= 0 || d % 16 || f % 16 ||
      (dtype != 0 && dtype != 1) || act < 0 || act > 3 || !x || !wu || !wd ||
      !y || (ws_bytes > 0 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchPlan pl = {block_t, cluster, cols, chunk, stages, groups,
                         per_group, chunks, smem, grid_x, grid_y, grid_z,
                         ws_bytes};
  const int r = check_plan(dtype, t, d, f, pl);
  if (r != 0) return r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    Bf16Params p;
    p.y = y;
    p.ws = pl.groups > 1 ? static_cast<float*>(ws) : nullptr;
    p.t = t; p.d = d; p.act = act; p.gated = wg != nullptr;
    p.cluster = pl.cluster;
    p.stages = pl.stages; p.per_group = pl.per_group; p.chunks = pl.chunks;
    switch (pl.cols / 2) {
      case 32: return launch_bf16<32>(pl, p, x, wg, wu, wd, f, s);
      case 64: return launch_bf16<64>(pl, p, x, wg, wu, wd, f, s);
      case 128: return launch_bf16<128>(pl, p, x, wg, wu, wd, f, s);
      case 224: return launch_bf16<224>(pl, p, x, wg, wu, wd, f, s);
      default: return launch_bf16<kMaxWidth>(pl, p, x, wg, wu, wd, f, s);
    }
  }
  F32Params p;
  p.x = static_cast<const float*>(x);
  p.wg = static_cast<const float*>(wg);
  p.wu = static_cast<const float*>(wu);
  p.wd = static_cast<const float*>(wd);
  p.ws = static_cast<float*>(ws);
  p.t = t; p.d = d; p.f = f; p.fr = pl.chunk; p.act = act;
  p.t_pad = static_cast<int>(pl.grid_x) * kF32BT;
  return launch_f32(pl, p, y, s);
}

// How many clusters of the bf16 kernel, `cluster` blocks of width nw with
// `smem` bytes of shared memory each (a plan's), can be resident at once on
// the current device (cudaOccupancyMaxActiveClusters), or a negative error
// code.
extern "C" int fused_ffn_max_clusters(int cluster, int nw, int smem) {
  if ((cluster != 1 && cluster != 2 && cluster != 4 &&
       cluster != kMaxCluster) || !is_width(nw) || smem < 1 ||
      smem > kSmemLimit)
    return -static_cast<int>(cudaErrorInvalidValue);
  LaunchPlan pl = {};
  pl.cluster = cluster;
  pl.smem = smem;
  pl.grid_x = cluster;
  pl.grid_y = pl.grid_z = 1;
  int n = -1;
  cudaError_t e = cudaSuccess;
  switch (nw) {
    case 32: e = max_clusters<32>(pl, &n); break;
    case 64: e = max_clusters<64>(pl, &n); break;
    case 128: e = max_clusters<128>(pl, &n); break;
    case 224: e = max_clusters<224>(pl, &n); break;
    default: e = max_clusters<kMaxWidth>(pl, &n); break;
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" const char* fused_ffn_error_string(int code) {
  static char buf[160];
  if (code == kEncodeFailed) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             g_last_encode_result);
    return buf;
  }
  if (code == kBadPlan) return g_refusal;
  if (code == kNoCluster) {
    snprintf(buf, sizeof(buf),
             "no cluster of %d blocks with %d bytes of shared memory each fits "
             "on this device (cudaOccupancyMaxActiveClusters returned 0)",
             g_cluster_size, g_cluster_smem);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
