// Greedy NMS as a fixed point, one block per row of a batch of NMS problems.
//
// Replaces the device-side loop of facerec_tpu/ops/nms.py::nms, the
// jax.lax.while_loop (:103-115) that iterates "box i survives iff it was a
// candidate (keep0[i]) and no surviving box j that may suppress it
// (sup[i, j]) survives" until a round changes nothing. The suppression
// relation points strictly up the score order (ties to the lower index), so
// the synchronous iteration reaches classic greedy NMS in (chain depth + 1)
// rounds, at most N. The float work (the overlap matrix, the score order)
// stays in PyTorch (facerec_torch/ops/nms.py); the kernel takes the boolean
// matrix and returns the boolean fixed point, so it equals the plain loop
// (nms_fixed_point_plain) bit for bit.
//
// Inputs: sup [M, N, N] bool (one byte each, sup[m, i, j]: j can suppress i)
// and keep0 [M, N] bool. Outputs: keep [M, N] bool and, per row, the number
// of rounds run: the round that changed nothing included, N if it never
// came (it always comes within N rounds for an order-respecting sup).
//
// Design. Block m packs row m's N x N bytes into N x W 32-bit words in
// shared memory (W = ceil(N / 32)): 16-byte loads where the row is aligned,
// a shared atomicOr per nonzero byte (sup is sparse: most pairs do not
// overlap). The block has 32 W threads, thread i owning box i and warp w the
// keep word w. A round is W word ANDs per thread, a __ballot_sync per warp
// to form the new keep words (double-buffered in shared memory), and one
// __syncthreads_or that both publishes them and says whether any changed.
// The host never waits: the loop ends on the device, as the TPU's
// while_loop does.
//
// Bound on the H100: bytes. The function must read M N^2 bytes of sup (12.6
// MB for the serve step's cross-scale call, M 48 x N 512: 3.8 us at 3.35
// TB/s) and M N bytes of keep0, and write M N + 4 M bytes; a round is N W
// word operations on data already in shared memory, a few rounds a call.
// Largest N: kMaxN = 1024, whose packed matrix takes 128 KB of shared
// memory (one block per SM); the wrapper refuses larger N.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;
constexpr int kMaxWords = kMaxN / 32;
constexpr size_t kMaxSmem = (size_t(kMaxN) * kMaxWords + 2 * kMaxWords) * sizeof(uint32_t);

__device__ __forceinline__ void set_bit(uint32_t* bits, int W, int N, size_t e) {
  const int i = int(e / N);
  const int j = int(e - size_t(i) * N);
  atomicOr(&bits[i * W + (j >> 5)], 1u << (j & 31));
}

__device__ __forceinline__ void set_bytes(uint32_t* bits, int W, int N, size_t e, uint32_t v) {
  if (v == 0) return;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((v >> (8 * b)) & 0xffu) set_bit(bits, W, N, e + b);
}

__global__ void __launch_bounds__(1024) nms_fixed_point_kernel(
    const uint8_t* __restrict__ sup, const uint8_t* __restrict__ keep0,
    uint8_t* __restrict__ keep, int* __restrict__ rounds, int N) {
  extern __shared__ uint32_t smem[];
  const int W = (N + 31) >> 5;
  uint32_t* bits = smem;          // [N][W]: bit j of word (i, j / 32) is sup[i, j]
  uint32_t* cur = smem + N * W;   // [W] keep words of the last round
  uint32_t* nxt = cur + W;        // [W] keep words being formed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t m = blockIdx.x;
  const size_t nn = size_t(N) * N;
  const uint8_t* row = sup + m * nn;

  for (int e = tid; e < N * W; e += blockDim.x) bits[e] = 0;
  __syncthreads();

  // pack: bytes up to the first 16-byte boundary, 16-byte loads, the tail
  size_t head = (16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15;
  if (head > nn) head = nn;
  const size_t nvec = (nn - head) / 16;
  for (size_t e = tid; e < head; e += blockDim.x)
    if (row[e]) set_bit(bits, W, N, e);
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
#pragma unroll 4
  for (size_t v = tid; v < nvec; v += blockDim.x) {
    const uint4 x = __ldg(vec + v);
    if ((x.x | x.y | x.z | x.w) == 0) continue;
    const size_t e = head + 16 * v;
    set_bytes(bits, W, N, e, x.x);
    set_bytes(bits, W, N, e + 4, x.y);
    set_bytes(bits, W, N, e + 8, x.z);
    set_bytes(bits, W, N, e + 12, x.w);
  }
  for (size_t e = head + 16 * nvec + tid; e < nn; e += blockDim.x)
    if (row[e]) set_bit(bits, W, N, e);

  const bool k0 = tid < N && keep0[m * N + tid] != 0;
  const uint32_t w0 = __ballot_sync(0xffffffffu, k0);
  if (lane == 0) cur[warp] = w0;
  __syncthreads();

  const uint32_t* mine = bits + size_t(k0 ? tid : 0) * W;
  int taken = N;
  for (int r = 1; r <= N; ++r) {
    bool survives = false;
    if (k0) {
      uint32_t kill = 0;
      for (int w = 0; w < W; ++w) kill |= mine[w] & cur[w];
      survives = kill == 0;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, survives);
    int diff = 0;
    if (lane == 0) {
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

  if (tid < N) keep[m * N + tid] = (cur[tid >> 5] >> (tid & 31)) & 1u;
  if (tid == 0) rounds[m] = taken;
}

}  // namespace

// sup [M, N, N] and keep0 [M, N] bool, contiguous; keep [M, N] bool and
// rounds [M] int32 written. Launches on `stream`; returns cudaGetLastError().
extern "C" int nms_fixed_point_launch(const void* sup, const void* keep0, int M, int N,
                                      void* keep, void* rounds, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  // shared memory above 48 KB is an opt-in that holds per device: one
  // attribute call per device (every launch on devices past the 64th), made
  // before a CUDA graph captures the launch
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev >= 0 && dev < 64 ? 1ull << dev : 0;
  if (!(opted_in & bit)) {
    err = cudaFuncSetAttribute(nms_fixed_point_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= bit;
  }
  const int W = (N + 31) / 32;
  const size_t smem = (size_t(N) * W + 2 * W) * sizeof(uint32_t);
  nms_fixed_point_kernel<<<M, 32 * W, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sup), static_cast<const uint8_t*>(keep0),
      static_cast<uint8_t*>(keep), static_cast<int*>(rounds), N);
  return (int)cudaGetLastError();
}
