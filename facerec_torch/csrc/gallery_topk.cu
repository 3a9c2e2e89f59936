// Gallery top-k: cosine scores of each query against the valid prefix of a
// gallery matrix, reduced to the k best (score descending, ties to the lower
// row index) without writing the [B, G] score matrix to device memory.
//
// Replaces the Pallas kernel facerec_tpu/ops/gallery.py::_topk_kernel
// (launched by gallery_topk_pallas). The TPU grid walks gallery tiles in
// order on one core and carries the running top-k in VMEM scratch; CUDA
// blocks run in no order and carry nothing, so the work is split in two:
//
//   pass 1 (topk_partial): grid (query tiles, gallery splits). Each block
//     takes TQ queries and one contiguous chunk of gallery rows, computes
//     the scores in TQ x TG tiles with f32 FMAs (register micro-tiles of
//     2 queries x 4 rows, operands staged through shared memory in DK-wide
//     slices), and folds each tile into a per-query top-k held in shared
//     memory. It writes [B, splits, k] candidates.
//   pass 2 (topk_merge): one warp per query merges its splits * k
//     candidates into the final [B, k].
//
// At serve B is small (384) while G can reach 1M rows, so the parallelism
// comes from the gallery splits, sized by the wrapper to fill the 132 SMs.
// Rows at or past *count are never scored; count is read from device
// memory so the serve step needs no host read (the Pallas kernel takes it by
// scalar prefetch). When fewer than k rows are valid, the empty slots get
// score -1e30 and the lowest masked row indices, exactly what a masked
// top-k over the full score matrix returns.
//
// Bound on the H100: the gallery read (G * D * 2 bytes in bf16) against
// 2 * B * G * D FLOPs. At B = 384 the arithmetic intensity is ~384 FLOP per
// byte, above the card's balance point, so the kernel is bound by arithmetic;
// this version runs it on the CUDA cores in f32 (67 TFLOP/s peak) rather than
// on the tensor cores, which is the first thing to change when it is made
// fast. The Pallas kernel's packed score+lane int32 encoding is not carried
// over: scores come back as exact f32 sums.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 32;        // queries per block
constexpr int TG = 64;        // gallery rows per score tile
constexpr int DK = 32;        // depth of one shared-memory operand slice
constexpr int THREADS = 256;
constexpr int MAXK = 32;      // one running top-k slot per lane
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Strict order on (score, row): higher score first, then lower row. Row -1
// marks an empty slot, which loses to every filled one.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (ai < 0) return false;
  if (bi < 0) return true;
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_partial(const float* __restrict__ q, const T* __restrict__ g,
             const int* __restrict__ count_ptr, int B, int G, int D, int K,
             int rows_per_split, float* __restrict__ cand_v,
             int* __restrict__ cand_i) {
  __shared__ float qs[TQ][DK + 1];
  __shared__ float gs[TG][DK + 1];
  __shared__ float sc[TQ][TG + 1];
  __shared__ float topv[TQ][MAXK];
  __shared__ int topi[TQ][MAXK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int count = min(max(*count_ptr, 0), G);
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, count);

  for (int t = tid; t < TQ * MAXK; t += THREADS) {
    topv[t / MAXK][t % MAXK] = NEG;
    topi[t / MAXK][t % MAXK] = -1;
  }
  __syncthreads();

  const int tq = tid / 16;  // queries 2*tq, 2*tq+1 of the tile
  const int tg = tid % 16;  // rows tg + 16*j, j < 4

  for (int r0 = r_begin; r0 < r_end; r0 += TG) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int d0 = 0; d0 < D; d0 += DK) {
      for (int t = tid; t < TQ * DK; t += THREADS) {
        const int qq = t / DK, dd = t % DK, qi = q0 + qq, di = d0 + dd;
        qs[qq][dd] = (qi < B && di < D) ? q[(size_t)qi * D + di] : 0.f;
      }
      for (int t = tid; t < TG * DK; t += THREADS) {
        const int rr = t / DK, dd = t % DK, ri = r0 + rr, di = d0 + dd;
        gs[rr][dd] = (ri < r_end && di < D) ? load_f(g + (size_t)ri * D + di) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DK; ++dd) {
        const float a0 = qs[2 * tq][dd], a1 = qs[2 * tq + 1][dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = gs[tg + 16 * j][dd];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[2 * tq + i][tg + 16 * j] = acc[i][j];
    __syncthreads();

    // Fold the tile into the running top-k: warp w owns queries
    // w*TQ/8 .. (w+1)*TQ/8 - 1. Each lane holds two new rows and one old slot.
    for (int qq = warp * (TQ / 8); qq < (warp + 1) * (TQ / 8); ++qq) {
      const int ra = r0 + lane, rb = r0 + lane + 32;
      float va = ra < r_end ? sc[qq][lane] : NEG;
      int ia = ra < r_end ? ra : -1;
      float vb = rb < r_end ? sc[qq][lane + 32] : NEG;
      int ib = rb < r_end ? rb : -1;
      float bv = va;
      int bi = ia;
      if (beats(vb, ib, bv, bi)) { bv = vb; bi = ib; }
      warp_best(bv, bi);
      if (!beats(bv, bi, topv[qq][K - 1], topi[qq][K - 1])) continue;  // nothing enters
      float vo = lane < K ? topv[qq][lane] : NEG;
      int io = lane < K ? topi[qq][lane] : -1;
      __syncwarp();
      for (int s = 0; s < K; ++s) {
        float lv = vo;
        int li = io, which = 0;
        if (beats(va, ia, lv, li)) { lv = va; li = ia; which = 1; }
        if (beats(vb, ib, lv, li)) { lv = vb; li = ib; which = 2; }
        float wv = lv;
        int wi = li;
        warp_best(wv, wi);
        if (lane == 0) { topv[qq][s] = wv; topi[qq][s] = wi; }
        if (wi >= 0 && li == wi) {
          if (which == 0) io = -1;
          else if (which == 1) ia = -1;
          else ib = -1;
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int t = tid; t < TQ * K; t += THREADS) {
    const int qq = t / K, s = t % K, qi = q0 + qq;
    if (qi < B) {
      const size_t o = ((size_t)qi * nsplit + split) * K + s;
      cand_v[o] = topv[qq][s];
      cand_i[o] = topi[qq][s];
    }
  }
}

__global__ void topk_merge(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                           int B, int n, int K, float* __restrict__ out_v,
                           int* __restrict__ out_i) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= B) return;
  const float* cv = cand_v + (size_t)qi * n;
  const int* ci = cand_i + (size_t)qi * n;
  float pv = 0.f;
  int pi = -1;  // previous winner; the next winner is the best strictly after it
  for (int s = 0; s < K; ++s) {
    float lv = NEG;
    int li = -1;
    for (int c = lane; c < n; c += 32) {
      const float v = cv[c];
      const int i = ci[c];
      if ((s == 0 || beats(pv, pi, v, i)) && beats(v, i, lv, li)) { lv = v; li = i; }
    }
    warp_best(lv, li);
    if (lane == 0) {
      // an empty slot means every valid row is already placed, so slot s is
      // the (s - count)-th masked row: row index s
      out_v[(size_t)qi * K + s] = li < 0 ? NEG : lv;
      out_i[(size_t)qi * K + s] = li < 0 ? s : li;
    }
    pv = lv;
    pi = li;
  }
}

}  // namespace

extern "C" int gallery_topk_launch(const void* q, const void* g, int g_bf16,
                                   const void* count, int B, int G, int D, int K,
                                   int rows_per_split, int nsplit, void* cand_v,
                                   void* cand_i, void* out_v, void* out_i,
                                   void* stream) {
  if (K < 1 || K > MAXK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((B + TQ - 1) / TQ, nsplit);
  if (g_bf16) {
    topk_partial<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const float*)q, (const __nv_bfloat16*)g, (const int*)count, B, G, D, K,
        rows_per_split, (float*)cand_v, (int*)cand_i);
  } else {
    topk_partial<float><<<grid, THREADS, 0, st>>>(
        (const float*)q, (const float*)g, (const int*)count, B, G, D, K,
        rows_per_split, (float*)cand_v, (int*)cand_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 4;
  topk_merge<<<(B + warps_per_block - 1) / warps_per_block, 32 * warps_per_block, 0, st>>>(
      (const float*)cand_v, (const int*)cand_i, B, nsplit * K, K, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}
