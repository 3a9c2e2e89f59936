// Gallery top-k: cosine scores of each query against the valid prefix of a
// gallery matrix, reduced to the k best (score descending, ties to the lower
// row index) without writing the [B, G] score matrix to device memory.
//
// Replaces the Pallas kernel facerec_tpu/ops/gallery.py::_topk_kernel
// (launched by gallery_topk_pallas). The TPU grid walks gallery tiles in
// order on one core and carries the running top-k in VMEM scratch; CUDA
// blocks run in no order and carry nothing, so the work is split in two:
//
//   pass 1: grid (query tiles, gallery splits). Each block takes a tile of
//     queries and one contiguous run of gallery rows, keeps a per-query
//     top-k in shared memory and writes [B, splits, k] candidates.
//   pass 2 (topk_merge): one warp per query merges its splits * k
//     candidates into the final [B, k].
//
// Rows at or past *count are never scored; count is read from device memory
// so the serve step needs no host read (the Pallas kernel takes it by scalar
// prefetch). When fewer than k rows are valid, the empty slots get score
// -1e30 and the lowest masked row indices, exactly what a masked top-k over
// the full score matrix returns. The Pallas kernel's packed score+lane int32
// encoding is not carried over: scores come back as exact f32 sums.
//
// bf16 gallery (the serve default), topk_partial_bf16. As the Pallas kernel
// does, the queries are rounded to the gallery's dtype before the product,
// so every product is an exact bf16 x bf16 product summed in f32, which is
// what the tensor cores compute. Bound on the H100: at B = 384 the kernel
// does 2 * 384 = 768 operations per gallery byte, far above the card's
// balance of ~295 bf16 operations per HBM byte, so it is bound by the tensor
// cores (989 TFLOP/s); below about B = 300 it is bound by the gallery read
// (3.35 TB/s). The design follows from that:
//   - products on the tensor cores with wgmma (m64n128k16, bf16 in, f32
//     accumulate): each of the block's two warpgroups multiplies its 64
//     queries by a 128-row gallery tile, both operands read from shared
//     memory in the 128-byte swizzled layout wgmma expects;
//   - the block's 128 queries stay resident in shared memory for the whole
//     split, rounded to bf16 as they are staged (no cast launch), while the
//     gallery streams through a 4-stage cp.async ring of 128-row x 64-deep
//     tiles: loads run two stages ahead and one stage of products stays in
//     flight, so copies, products and the next issue overlap;
//   - the grid puts the query tiles of one split next to each other in
//     launch order and sizes the splits to one wave, so each gallery row
//     crosses HBM once and reaches the other query tiles from the L2;
//   - the splits cut the valid prefix (count, read on the device), not the
//     capacity, so a half-filled gallery still spreads over every block;
//   - a gated epilogue per tile: each score is compared once with its
//     query's k-th best; the few that pass go into the query's candidate
//     list, in slots that belong to the pushing thread (no atomics, and
//     only set bits are visited). A thread per query inserts its list into
//     the running top-k only when some thread's slots overflow (or at the
//     end), so merges grow rarer as the k-th best tightens. The first tile
//     seeds the top-k with each thread's best two rows per query, so that
//     few rows pass there. The epilogue does not yet overlap the
//     products; PERF.md gives its share of the time.
//
// f32 gallery, topk_partial_f32: f32 queries, products as f32 FMAs on the
// CUDA cores (67 TFLOP/s peak) in 2 x 4 register micro-tiles, each 64-row
// tile folded into the top-k by warp reductions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 32;      // one running top-k slot per lane
constexpr float NEG = -1e30f;

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

// ---------------------------------------------------------------------------
// f32 gallery: CUDA-core FMAs.

constexpr int TQ = 32;        // queries per block
constexpr int TG = 64;        // gallery rows per score tile
constexpr int DK = 32;        // depth of one shared-memory operand slice
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
topk_partial_f32(const float* __restrict__ q, const float* __restrict__ g,
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
        gs[rr][dd] = (ri < r_end && di < D) ? g[(size_t)ri * D + di] : 0.f;
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

// ---------------------------------------------------------------------------
// bf16 gallery: tensor cores.

constexpr int BQ = 128;          // queries resident per block
constexpr int BG = 128;          // gallery rows per tile
constexpr int BK = 64;           // depth of one ring stage: 128 bytes per row
constexpr int TC_THREADS = 256;  // two warpgroups, 64 queries each
constexpr int HOLDERS = 4;       // threads holding one query's rows of a tile
constexpr int TILE_BYTES = BG * BK * 2;   // one ring stage, and one 64-deep query block
constexpr int SMEM_ALIGN = 1024;          // 128-byte swizzle atoms: 8 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c (< 8) of row r in a [rows][64] bf16 tile
// with the 128-byte swizzle that wgmma reads: the chunk is XORed with the
// row's position in its 8-row atom.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (stores and cp.async) visible to
// the tensor cores' reads, which go through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major bf16 tile in 128-byte swizzle atoms laid
// one after the other (8 rows x 128 bytes each, 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 128] (+)= a[64 x 16] * b[128 x 16]^T for one warpgroup, both
// operands K-major in shared memory, f32 accumulators: d[4j + 2h + e] is
// row 16 (warp % 4) + lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_64x128x16(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

// Merge the candidate lists into the sorted top-k and empty them: thread
// q < BQ takes query q, reads its ccap slots (row -1 marks an empty one) and
// inserts each candidate (once the k-th best is tight, most fail the first
// compare). The top-k and the lists are laid out [slot][query], so that
// neighbouring threads touch neighbouring words.
__device__ __forceinline__ void merge_lists(float* topv, int* topi, const float* cv, int* ci,
                                         int K, int ccap, int tid) {
  if (tid >= BQ) return;
  float kv = topv[(K - 1) * BQ + tid];
  int ki = topi[(K - 1) * BQ + tid];
#pragma unroll 4
  for (int c = 0; c < ccap; ++c) {
    const int r = ci[c * BQ + tid];
    if (r < 0) continue;
    ci[c * BQ + tid] = -1;
    const float v = cv[c * BQ + tid];
    if (!beats(v, r, kv, ki)) continue;
    int s = K - 1;
    for (; s > 0; --s) {
      const float pv = topv[(s - 1) * BQ + tid];
      const int pi = topi[(s - 1) * BQ + tid];
      if (!beats(v, r, pv, pi)) break;
      topv[s * BQ + tid] = pv;
      topi[s * BQ + tid] = pi;
    }
    topv[s * BQ + tid] = v;
    topi[s * BQ + tid] = r;
    kv = topv[(K - 1) * BQ + tid];
    ki = topi[(K - 1) * BQ + tid];
  }
}

// STAGES: depth of the cp.async ring of gallery tiles. Loads run
// STAGES - 2 stages ahead of the products, and one stage of products stays
// in flight on the tensor cores while the next is issued.
template <int STAGES>
__global__ void __launch_bounds__(TC_THREADS, 1)
topk_partial_bf16(const float* __restrict__ q, const __nv_bfloat16* __restrict__ g,
                  const int* __restrict__ count_ptr, int B, int G, int D, int K, int ccap,
                  float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) &
                                    (SMEM_ALIGN - 1));
  const int nk = (D + BK - 1) / BK;  // 64-deep blocks of the (padded) depth
  unsigned char* qs = smem;                        // [nk][BQ][64] bf16, swizzled
  unsigned char* gs = qs + nk * TILE_BYTES;        // [STAGES][BG][64] bf16, swizzled
  float* topv = reinterpret_cast<float*>(gs + STAGES * TILE_BYTES);  // [K][BQ], sorted
  int* topi = reinterpret_cast<int*>(topv + BQ * K);
  // [ccap][BQ] candidates: slots holder * sub .. holder * sub + sub - 1 of
  // a query belong to the holder-th of the HOLDERS threads that hold the
  // query's rows, which fills them without atomics
  float* cv = reinterpret_cast<float*>(topi + BQ * K);
  int* ci = reinterpret_cast<int*>(cv + BQ * ccap);
  const int sub = ccap / HOLDERS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int count = min(max(*count_ptr, 0), G);
  // whole tiles per split, from the valid prefix rather than the capacity
  const int per = ((count + nsplit - 1) / nsplit + BG - 1) / BG * BG;
  const int r_begin = split * per;
  const int r_end = min(r_begin + per, count);
  const int ntiles = r_end > r_begin ? (r_end - r_begin + BG - 1) / BG : 0;
  const int nload = ntiles * nk;

  if (nload == 0) {  // no valid row in this split
    for (int t = tid; t < BQ * K; t += TC_THREADS) {
      const int qi = q0 + t / K;
      if (qi < B) {
        const size_t o = ((size_t)qi * nsplit + split) * K + t % K;
        cand_v[o] = NEG;
        cand_i[o] = -1;
      }
    }
    return;
  }

  // Load the next (tile, depth block) into the next ring slot, tile-major.
  constexpr int LEAD = STAGES - 2;
  int ld_t = 0, ld_kc = 0, ld_slot = 0;
  auto load_next = [&]() {
    const int r0 = r_begin + ld_t * BG, d0 = ld_kc * BK;
    const uint32_t base = smem_u32(gs + ld_slot * TILE_BYTES);
    if (++ld_kc == nk) { ld_kc = 0; ++ld_t; }
    if (++ld_slot == STAGES) ld_slot = 0;
#pragma unroll
    for (int j = 0; j < BG * BK / 8 / TC_THREADS; ++j) {
      const int id = tid + j * TC_THREADS, r = id >> 3, c = id & 7;
      const int row = r0 + r, col = d0 + c * 8;
      const bool ok = row < r_end && col < D;
      cp_async16(base + swz128(r, c), ok ? g + (size_t)row * D + col : g, ok);
    }
  };

  for (int t = tid; t < BQ * K; t += TC_THREADS) { topv[t] = NEG; topi[t] = -1; }
  for (int t = tid; t < BQ * ccap; t += TC_THREADS) ci[t] = -1;
#pragma unroll
  for (int s = 0; s < LEAD; ++s) {
    if (s < nload) load_next();
    cp_async_commit();
  }
  // Stage the queries, rounded to bf16, while the first tiles are in flight.
  for (int id = tid; id < BQ * nk * 8; id += TC_THREADS) {
    const int r = id / (nk * 8), c = id - r * (nk * 8), qi = q0 + r, col = c * 8;
    uint4 p = make_uint4(0u, 0u, 0u, 0u);
    if (qi < B && col < D) {
      const float4 a = *reinterpret_cast<const float4*>(q + (size_t)qi * D + col);
      const float4 b = *reinterpret_cast<const float4*>(q + (size_t)qi * D + col + 4);
      p = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(qs + (c >> 3) * TILE_BYTES + swz128(r, c & 7)) = p;
  }

  // This thread's scores: acc[4j + 2h + e] is block query
  // qh = 64 wg + 16 (warp % 4) + lane / 4 + 8h against row r0 + 8j + e of
  // the tile, with r0 = 2 (lane % 4). The 4 lanes with equal lane / 4 hold
  // a query's 128 rows, 32 each.
  float acc[64];
  const int qa = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int holder = lane & 3;
  int held[2] = {0, 0};  // this thread's filled slots for queries qa, qa + 8

  int s = 0, slot = 0;  // load s, and its ring slot, holds depth block kc of tile t
  for (int t = 0; t < ntiles; ++t) {
    for (int kc = 0; kc < nk; ++kc, ++s) {
      cp_async_wait<LEAD - 1>();  // load s has landed (this thread's part)
      fence_async_shared();
      // everyone's part has; and the products of stage s - 2, whose slot
      // the next load takes, are done in every warpgroup
      __syncthreads();
      if (s + LEAD < nload) load_next();
      cp_async_commit();
      const uint32_t gbase = smem_u32(gs + slot * TILE_BYTES);
      const uint32_t qbase = smem_u32(qs + kc * TILE_BYTES) + wg * 64 * 128;
      if (++slot == STAGES) slot = 0;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_64x128x16(acc, sw128_desc(qbase + ks * 32), sw128_desc(gbase + ks * 32),
                        kc > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // stage s - 1 done; stage s stays in flight
    }
    wgmma_wait<0>();

    // Gated epilogue of tile t. Bit 32h + 2j + e of a mask stands for
    // acc[4j + 2h + e].
    const int r0 = r_begin + t * BG + 2 * holder;
    // The scores of mask at or above their query's k-th best as of the last
    // merge: one compare per score. Scores equal to the k-th best pass
    // whatever their row; the merge orders them exactly.
    auto filter = [&](uint64_t mask) {
      uint64_t keep = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float kv = topv[(K - 1) * BQ + qa + 8 * h];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (acc[4 * j + 2 * h + e] >= kv) keep |= 1ull << (32 * h + 2 * j + e);
      }
      return mask & keep;
    };
    // Push the scores of mask into this thread's slots of their queries'
    // candidate lists; returns those that found the slots full. Only set
    // bits are visited (a 32-way select fetches each score), so a thread
    // with nothing to push spends nothing.
    auto push = [&](uint64_t mask) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t m = (uint32_t)(mask >> (32 * h)), left = 0;
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          if (held[h] == sub) {
            left |= 1u << b;
            continue;
          }
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 32; ++k)
            if (k == b) v = acc[4 * (k >> 1) + 2 * h + (k & 1)];
          const int c = (holder * sub + held[h]++) * BQ + qa + 8 * h;
          cv[c] = v;
          ci[c] = r0 + 8 * (b >> 1) + (b & 1);
        }
        mask = (mask & ~(0xffffffffull << (32 * h))) | ((uint64_t)left << (32 * h));
      }
      return mask;
    };
    auto merge = [&]() {
      merge_lists(topv, topi, cv, ci, K, ccap, tid);
      held[0] = held[1] = 0;
    };
    uint32_t rows_ok = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (r0 + 8 * j + e < r_end) rows_ok |= 1u << (2 * j + e);
    uint64_t pend = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (q0 + qa + 8 * h < B) pend |= (uint64_t)rows_ok << (32 * h);
    if (t == 0) {
      // Seed the empty top-k with each thread's best two rows per query
      // (they always fit its slots; 4 threads give 8 per query): the k-th
      // best is then tight before the other rows are offered.
      uint64_t seed = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v1 = NEG, v2 = NEG;
        int i1 = -1, i2 = -1;
        uint64_t b1 = 0, b2 = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint64_t bit = 1ull << (32 * h + 2 * j + e);
            const float v = acc[4 * j + 2 * h + e];
            const int row = r0 + 8 * j + e;
            if (!(pend & bit)) continue;
            if (beats(v, row, v1, i1)) {
              v2 = v1; i2 = i1; b2 = b1;
              v1 = v; i1 = row; b1 = bit;
            } else if (beats(v, row, v2, i2)) {
              v2 = v; i2 = row; b2 = bit;
            }
          }
        seed |= b1 | b2;
      }
      push(seed);
      pend &= ~seed;
      __syncthreads();
      merge();
      __syncthreads();
    }
    // Offer what beats the k-th best; merge only when some thread's slots
    // overflow. Otherwise the candidates wait in the lists for later tiles.
    for (;;) {
      pend = push(filter(pend));
      if (!__syncthreads_or(pend != 0)) break;
      merge();
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  merge_lists(topv, topi, cv, ci, K, ccap, tid);
  __syncthreads();

  for (int t = tid; t < BQ * K; t += TC_THREADS) {
    const int qi = q0 + t / K, slot = t % K;
    if (qi < B) {
      const size_t o = ((size_t)qi * nsplit + split) * K + slot;
      cand_v[o] = topv[slot * BQ + t / K];
      cand_i[o] = topi[slot * BQ + t / K];
    }
  }
}

// ---------------------------------------------------------------------------

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

// Dynamic shared memory of topk_partial_bf16<stages>, or 0 where it does
// not fit.
size_t bf16_smem(int D, int K, int stages, int ccap, int limit) {
  const size_t nk = (size_t)(D + BK - 1) / BK;
  const size_t bytes = SMEM_ALIGN + nk * TILE_BYTES + (size_t)stages * TILE_BYTES +
                       (size_t)BQ * K * 8 + (size_t)BQ * ccap * 8;
  return bytes <= (size_t)limit ? bytes : 0;
}

}  // namespace

// rows_per_split is used by the f32 path only; the bf16 path cuts the valid
// prefix into nsplit runs on the device. D must be a multiple of 16 and the
// query and gallery pointers 16-byte aligned for the bf16 path.
extern "C" int gallery_topk_launch(const void* q, const void* g, int g_bf16,
                                   const void* count, int B, int G, int D, int K,
                                   int rows_per_split, int nsplit, void* cand_v,
                                   void* cand_i, void* out_v, void* out_i,
                                   void* stream) {
  if (K < 1 || K > MAXK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (g_bf16) {
    if (D % 16 != 0) return (int)cudaErrorInvalidValue;
    // per device: the opt-in shared memory limit, and the most dynamic
    // shared memory each instance has been allowed so far
    constexpr int MAX_DEVICES = 64;
    static int limit[MAX_DEVICES] = {0};
    static size_t allowed[MAX_DEVICES][2] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (limit[dev] == 0) {
      err = cudaDeviceGetAttribute(&limit[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return (int)err;
    }
    // the deepest ring, then the longest candidate lists, that fit
    int stages = 0, ccap = 0;
    size_t smem = 0;
    for (int st_try = 4; st_try >= 3 && smem == 0; --st_try)
      for (int cc = 32; cc >= 16 && smem == 0; cc /= 2)
        if ((smem = bf16_smem(D, K, st_try, cc, limit[dev])) != 0) {
          stages = st_try;
          ccap = cc;
        }
    if (smem == 0) return (int)cudaErrorInvalidValue;
    auto kernel = stages == 4 ? topk_partial_bf16<4> : topk_partial_bf16<3>;
    if (smem > allowed[dev][stages - 3]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed[dev][stages - 3] = smem;
    }
    dim3 grid((B + BQ - 1) / BQ, nsplit);
    kernel<<<grid, TC_THREADS, smem, st>>>(
        (const float*)q, (const __nv_bfloat16*)g, (const int*)count, B, G, D, K, ccap,
        (float*)cand_v, (int*)cand_i);
  } else {
    dim3 grid((B + TQ - 1) / TQ, nsplit);
    topk_partial_f32<<<grid, THREADS, 0, st>>>(
        (const float*)q, (const float*)g, (const int*)count, B, G, D, K, rows_per_split,
        (float*)cand_v, (int*)cand_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 4;
  topk_merge<<<(B + warps_per_block - 1) / warps_per_block, 32 * warps_per_block, 0, st>>>(
      (const float*)cand_v, (const int*)cand_i, B, nsplit * K, K, (float*)out_v,
      (int*)out_i);
  return (int)cudaGetLastError();
}
