// Greedy NMS from the boxes, one block per row of a batch of NMS problems:
// the overlap test, the score order and the fixed point in one kernel.
//
// Replaces facerec_tpu/ops/nms.py::nms from the overlap matrix (:70) through
// the device-side jax.lax.while_loop (:103-115) that iterates "box i
// survives iff it is a candidate (keep0[i]) and no surviving box j that may
// suppress it (sup[i, j]) survives" until a round changes nothing. Here
// sup[i, j] = overlap(i, j) > threshold, j dominates i (a higher score, ties
// to the lower index) and j is valid, as facerec_torch/ops/nms.py builds it
// in its plain version (nms_suppress_plain). The suppression relation points
// strictly up the score order, so the synchronous iteration reaches classic
// greedy NMS in (chain depth + 1) rounds, at most N.
//
// Inputs: boxes [M, N, 4] f32 (x1, y1, x2, y2), the masked scores s0 [M, N]
// f32 (-inf where a box is invalid), valid [M, N] bool, the threshold (f32,
// as PyTorch compares an f32 tensor with a Python float), the overlap mode
// (union: IoU; min: intersection over the smaller area; dupmin: min for
// pairs whose areas lie within 2.5x, IoU otherwise). Outputs: keep [M, N]
// bool and, per row, the rounds run: the round that changed nothing
// included, N if it never came.
//
// Bit for bit with the plain version. A `>` against the threshold turns a
// 1-ulp difference of the overlap into a flipped bit, so each pair's overlap
// is computed in overlap_matrix's order of f32 operations, each rounded on
// its own as PyTorch's separate elementwise kernels round it: __fsub_rn,
// __fmul_rn, __fadd_rn and __fdiv_rn (nvcc would contract ai + aj - w * h
// into an FMA), and max/min that return NaN for a NaN operand, as
// torch.maximum, torch.minimum and torch.clamp do. The sign of a zero can
// differ from PyTorch's, and no comparison below depends on it.
//
// Design. Block m stages row m's boxes, areas and scores in shared memory.
// Warps build the suppression words with no atomics: a warp holds the 32
// boxes j of one word column in registers (lane l: box 32 w + l), walks a
// contiguous run of rows i, and each lane tests its pair; __ballot_sync
// makes the word, which lane 0 stores. The words are kept transposed
// ([W][N]), so that in the rounds thread i reads its W words from
// consecutive addresses with no bank conflict. A round is W word ANDs per
// thread, a __ballot_sync per warp to form the new keep words
// (double-buffered in shared memory), and one __syncthreads_or that both
// publishes them and says whether any changed. The host never waits: the
// loop ends on the device, as the TPU's while_loop does. The [M, N, N]
// overlap and suppression matrices of the plain version never reach global
// memory. A block has W warps at least (one thread a box in the rounds) and
// more for the build where the grid leaves SMs idle: the 48-row calls take
// up to 32 warps a block, the 432-row call 10.
//
// Bound on the H100: operations. The function reads 21 bytes a box and
// writes 1 a box and 4 a row (48 x 192 boxes, the cross-scale call: 0.06 us
// at 3.35 TB/s), and computes N^2 overlaps a row of 13-20 f32 operations
// each (0.53 us at 67 TFLOP/s for the same call, 20 in dupmin mode). The kernel issues its
// pairs on one SM a row, so a call with fewer rows than SMs leaves SMs idle.
// Largest N: kMaxN = 1024, whose words take 128 KB of shared memory beside
// 24 KB of staged boxes (one block per SM); the wrapper refuses larger N.
// The serve step's five calls (M x N): per-scale 432 x 64 (union),
// cross-scale 48 x 192 (dupmin), R-Net 48 x 32 (union), large-face 48 x 32
// (union), final 48 x 20 (min).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;
constexpr int kMaxWords = kMaxN / 32;
constexpr int kModes = 3;  // 0 union, 1 min, 2 dupmin (ops/nms.py's MODES order)
constexpr size_t kMaxSmem = size_t(kMaxN) * (sizeof(float4) + sizeof(float2)) +
                            (size_t(kMaxWords) * kMaxN + 3 * kMaxWords) * sizeof(uint32_t);

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// box_area: clamp(x2 - x1, min=0) * clamp(y2 - y1, min=0)
__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f), max_nan(__fsub_rn(b.w, b.y), 0.f));
}

// overlap_matrix(boxes, mode)[i, j] > t, in overlap_matrix's order of operations
template <int kMode>
__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj, float aj, float t) {
  const float x1 = max_nan(bi.x, bj.x), y1 = max_nan(bi.y, bj.y);
  const float x2 = min_nan(bi.z, bj.z), y2 = min_nan(bi.w, bj.w);
  const float inter =
      __fmul_rn(max_nan(__fsub_rn(x2, x1), 0.f), max_nan(__fsub_rn(y2, y1), 0.f));
  float denom;
  if (kMode == 1) {
    denom = min_nan(ai, aj);
  } else {
    const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
    if (kMode == 0) {
      denom = uni;
    } else {
      const float a_min = min_nan(ai, aj);
      const bool similar = max_nan(ai, aj) <= __fmul_rn(2.5f, max_nan(a_min, 1e-12f));
      denom = similar ? a_min : uni;
    }
  }
  const float d = max_nan(denom, 1e-12f);
  // d is at least 1e-12, +inf or NaN: 0 / d is the zero itself unless d is
  // NaN, so only overlapping pairs pay for the division
  const float q = inter > 0.f ? __fdiv_rn(inter, d) : (d == d ? inter : d);
  return q > t;
}

template <int kMode>
__global__ void __launch_bounds__(1024) nms_suppress_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const uint8_t* __restrict__ valid, int N, float threshold, uint8_t* __restrict__ keep,
    int* __restrict__ rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (N + 31) >> 5;
  float4* box = reinterpret_cast<float4*>(smem);       // [N]
  float2* as = reinterpret_cast<float2*>(box + N);     // [N] (area, score)
  uint32_t* bits = reinterpret_cast<uint32_t*>(as + N);  // [W][N]: bit l of (w, i): 32 w + l may kill i
  uint32_t* vword = bits + size_t(W) * N;              // [W] valid words
  uint32_t* cur = vword + W;                           // [W] keep words of the last round
  uint32_t* nxt = cur + W;                             // [W] keep words being formed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t row = size_t(blockIdx.x) * N;

  for (int i = tid; i < N; i += blockDim.x) {
    const float* b = boxes + (row + i) * 4;
    const float4 bi = make_float4(b[0], b[1], b[2], b[3]);
    box[i] = bi;
    as[i] = make_float2(area(bi), scores[row + i]);
  }
  for (int w = warp; w < W; w += nwarps) {
    const int j = 32 * w + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, j < N && valid[row + j] != 0);
    if (lane == 0) vword[w] = word;
  }
  __syncthreads();

  // the words: warp g takes the run [g per, (g + 1) per) of the W N words,
  // word e = w N + i
  const int total = W * N;
  const int per = (total + nwarps - 1) / nwarps;
  int e = warp * per;
  const int end = min(e + per, total);
  int w = e / N, i = e - w * N;
  int j = 32 * w + lane;
  float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 sj = make_float2(0.f, 0.f);
  if (e < end && j < N) {
    bj = box[j];
    sj = as[j];
  }
  for (; e < end; ++e) {
    const float4 bi = box[i];
    const float2 si = as[i];
    bool bit = false;
    if (j < N && (sj.y > si.y || (sj.y == si.y && j < i)))
      bit = overlaps<kMode>(bi, si.x, bj, sj.x, threshold);
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) bits[e] = word & vword[w];
    if (++i == N && e + 1 < end) {
      i = 0;
      ++w;
      j = 32 * w + lane;
      if (j < N) {
        bj = box[j];
        sj = as[j];
      }
    }
  }

  const bool k0 = tid < N && valid[row + tid] != 0 && as[tid].y > __int_as_float(0xff800000);
  const uint32_t w0 = __ballot_sync(0xffffffffu, k0);
  if (lane == 0 && warp < W) cur[warp] = w0;
  __syncthreads();

  int taken = N;
  for (int r = 1; r <= N; ++r) {
    bool survives = false;
    if (k0) {
      uint32_t kill = 0;
      for (int v = 0; v < W; ++v) kill |= bits[size_t(v) * N + tid] & cur[v];
      survives = kill == 0;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, survives);
    int diff = 0;
    if (lane == 0 && warp < W) {
      nxt[warp] = word;
      diff = word != cur[warp];
    }
    const int changed = __syncthreads_or(diff);
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!changed) {
      taken = r;
      break;
    }
  }

  if (tid < N) keep[row + tid] = (cur[tid >> 5] >> (tid & 31)) & 1u;
  if (tid == 0) rounds[blockIdx.x] = taken;
}

using Kernel = void (*)(const float*, const float*, const uint8_t*, int, float, uint8_t*, int*);
const Kernel kKernels[kModes] = {nms_suppress_kernel<0>, nms_suppress_kernel<1>,
                                     nms_suppress_kernel<2>};

}  // namespace

// boxes [M, N, 4] f32, s0 [M, N] f32 and valid [M, N] bool, contiguous;
// keep [M, N] bool and rounds [M] int32 written; mode 0 union, 1 min, 2
// dupmin. Launches on `stream`; returns cudaGetLastError().
extern "C" int nms_suppress_launch(const void* boxes, const void* scores, const void* valid,
                                   int M, int N, float threshold, int mode,
                                   void* keep, void* rounds, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (N > kMaxN || mode < 0 || mode >= kModes) return (int)cudaErrorInvalidValue;
  // shared memory above 48 KB is an opt-in that holds per device and kernel:
  // one attribute call per device (every launch on devices past the 64th),
  // made before a CUDA graph captures the launch
  static unsigned long long opted_in[kModes] = {0, 0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev >= 0 && dev < 64 ? 1ull << dev : 0;
  if (!(opted_in[mode] & bit)) {
    err = cudaFuncSetAttribute(kKernels[mode], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in[mode] |= bit;
  }
  // warps a block: about 32 warps an SM over the grid and at least 2 words
  // a warp, within [W, 32] (from a sweep of 1-32 warps a block at each of
  // the serve step's five calls on one H100: tools/torch_nms_times.py --warps)
  const int W = (N + 31) / 32;
  int sms = 132;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int warps = (32 * sms + M - 1) / M;
  if (warps > (W * N + 1) / 2) warps = (W * N + 1) / 2;
  if (warps > 32) warps = 32;
  if (warps < W) warps = W;
  const size_t smem = size_t(N) * (sizeof(float4) + sizeof(float2)) +
                      (size_t(W) * N + 3 * W) * sizeof(uint32_t);
  kKernels[mode]<<<M, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), N, threshold, static_cast<uint8_t*>(keep),
      static_cast<int*>(rounds));
  return (int)cudaGetLastError();
}
