// 2-shear patch rotation: a y-shear then an x-shear of each bf16 patch,
// writing only the centred E x E crop.
//
// Replaces the Pallas kernel facerec_tpu/ops/pallas_warp.py::_rotate_kernel
// (launched by rotate_patches_pallas). The two shears are the LDU remainder
// of the eye-levelling rotation (facerec_torch/ops/warp_fast.py
// _shear_params). Each shear moves every line (a column for the y pass, a
// row for the x pass) by its own shift; the TPU kernel realises the shift as
// a coarse one-hot translate at granularity 8 followed by a 9-tap fine pass.
// Because the coarse slots are one-hot and only two fine taps carry weight,
// each line reduces to one integer offset o and two bf16 weights (w0, w1):
//
//   y pass:  t[y, x] = w0y[x] * p[y + oy[x], x] + w1y[x] * p[y + oy[x] + 1, x]
//   x pass:  o[y, x] = w0x[y] * t[y, x + ox[y]] + w1x[y] * t[y, x + ox[y] + 1]
//
// with zeros outside the patch. Each product and each sum is rounded to
// bf16 in the order warp_fast._shear adds its taps, so the kernel equals
// warp_fast.rotate_patches bit for bit. The kernel does that arithmetic in
// bf16 instructions: above f32's normal floor (2^-126) the product of two
// bf16 values is exact in f32, and the sum of two bf16 values is exact in
// f32 or too lopsided to reach a bf16 tie, so one bf16 rounding gives what
// PyTorch's f32-then-bf16 rounding gives.
//
// Line taps. The wrapper passes each patch's two slopes and two consts (f32)
// and the static windows ky, kx. A block computes the offset and weights of
// the P column lines and of its kept row lines into shared memory, op by op
// as warp_fast._shear_lines and warp_kernel.line_taps do in PyTorch: every
// product and sum is a separate IEEE-rounded f32 operation (__fmul_rn /
// __fadd_rn, so nvcc cannot contract a*b+c into an FMA), and the offset is
// 8*c + floor(r + frac), which is base + 1 where r + frac rounds up to the
// next integer.
//
// Design. A block owns one patch, or one of `segments` row ranges of it, and
// walks its output rows down in bands of `band` rows. The input rows a band's
// y pass reads (its rows shifted by the patch's offset range [lo, hi]) sit in
// a ring of H rows in shared memory, filled with 16-byte cp.async copies of
// whole rows (1,248 B at P 208, C 3) in two commit groups per band: the rows
// the next band needs, then as many more as the ring can take. Each patch row
// is loaded once per block. A y-pass work item takes one column's C values
// down kChunk rows: it reads the kChunk + 1 patch rows it needs first, so the
// reads are in flight together and each value is read once, then writes the
// band's rows of t in bf16, for just the columns the band's x pass reads
// (zeros for those outside the patch). Each t row is stored shifted so that
// its x-pass reads start on 16 bytes: an x-pass work item reads two 16-byte
// vectors, takes the second tap's values with byte permutes, and writes 8 crop
// values with one 16-byte store (C = 3; other channel counts and unaligned
// crops take an element-wise path). Index arithmetic is 32-bit; work items
// step through their index space by additions, with no division per item.
// The launcher sizes the ring and band to fit two blocks on an SM (one where
// the window is too tall), and picks `segments` so the last wave of blocks is
// not mostly empty; the caller may force either, to measure the choice.
//
// Bound on the H100: bytes. The function must read the patch values the crop
// reaches (about (E+1)^2 per channel at any angle, as a shear keeps area:
// 60% of a 208 x 208 patch for a 160 crop) and 16 bytes of slopes and consts
// per patch, and write N*E*E*C*2 bytes of crops; its arithmetic (a dozen
// operations per output) is far below the card's balance point. The kernel
// loads whole rows of the row range its segment reaches, so it moves more.
// No tensor cores: each output is two products and a sum, each rounded to
// bf16, and a tensor-core product would accumulate in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>

namespace {

typedef unsigned short u16;

constexpr int kThreads = 512;
constexpr int kMaxBand = 16;           // output rows per band, at most
constexpr int kChunk = 8;              // rows one y-pass work item walks
constexpr int kMaxC = 4;               // channels, at most
constexpr int kSmemPerSm = 233472;     // 228 KB of shared memory per SM
constexpr int kSmemPerBlock = 232448;  // 227 KB, the most one block may use
constexpr int kSmemReserved = 1024;    // kept by the system for each block

struct Params {
  const u16* patches;  // [N, P, P*C] bf16 bits
  const float* slope_y;
  const float* const_y;
  const float* slope_x;
  const float* const_x;
  u16* out;  // [N, E, E*C] bf16 bits
  int P, E, C, ky, kx;
  int segments;   // row ranges of the crop, one block each
  int ring_rows;  // H: input rows the ring holds
  int band_rows;  // output rows of the band buffer
  int pad_l;      // columns left of the patch the band buffer has room for
  int t_pitch;    // band buffer row, in elements (a multiple of 8)
};

struct YTap {  // one column line of the y pass
  int off;
  unsigned w;  // bf16 w0 | w1 << 16
};

struct XTap {   // one kept row line of the x pass
  int read;     // element of the t row where the row's x-pass reads begin
  int col;      // 8 * (first t column the row reads, (P - E) / 2 + its offset) + shift
  unsigned w0;  // bf16 w0 in both halves
  unsigned w1;  // bf16 w1 in both halves
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline size_t taps_bytes(int P, int E) {
  return size_t(P) * sizeof(YTap) + size_t(E) * sizeof(XTap) + 16;
}

__device__ __forceinline__ u16 to_bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// bf16 arithmetic on raw bits, each result rounded to nearest even. An
// explicit rounding mode keeps ptxas from fusing a product and a sum.
__device__ __forceinline__ u16 mul1(u16 a, u16 b) {
  u16 d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

__device__ __forceinline__ u16 add1(u16 a, u16 b) {
  u16 d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// One line of one shear pass, as warp_fast._shear_lines + line_taps.
__device__ __forceinline__ void line_tap(float slope, float cst, float other, float k_lo,
                                         float k_top, int* off, u16* w0, u16* w1) {
  float shift = __fadd_rn(__fmul_rn(slope, other), cst);
  shift = fminf(fmaxf(shift, k_lo), k_top);
  const float base = floorf(shift);
  const float frac = __fsub_rn(shift, base);
  const float c = floorf(__fdiv_rn(base, 8.0f));
  const float r = __fsub_rn(base, __fmul_rn(c, 8.0f));
  const float f = __fadd_rn(r, frac);
  const float fb = floorf(f);
  const float ff = __fsub_rn(f, fb);
  *off = (int)__fadd_rn(__fmul_rn(c, 8.0f), fb);
  *w0 = to_bf(__fsub_rn(1.0f, ff));
  *w1 = to_bf(ff);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Patch rows [r_from, r_to] into their ring slots (row r -> slot r % H).
template <bool VEC>
__device__ __forceinline__ void load_rows(u16* ring, const u16* src, int r_from, int r_to, int H,
                                          int row_elems) {
  if (r_from > r_to) return;
  if (VEC) {
    const int cpr = row_elems / 8;  // 16-byte chunks per row
    const int total = (r_to - r_from + 1) * cpr;  // at most H rows
    const int slot0 = r_from % H;
    const int step_r = kThreads / cpr, step_c = kThreads - step_r * cpr;
    int rr = threadIdx.x / cpr, cc = threadIdx.x - rr * cpr;  // chunk q: row q / cpr, q % cpr
    for (int q = threadIdx.x; q < total; q += kThreads) {
      int slot = slot0 + rr;
      slot -= slot >= H ? H : 0;
      cp_async16(ring + slot * row_elems + cc * 8, src + (r_from + rr) * row_elems + cc * 8);
      cc += step_c;
      rr += step_r;
      if (cc >= cpr) {
        cc -= cpr;
        ++rr;
      }
    }
  } else {
    const int total = (r_to - r_from + 1) * row_elems;
    for (int q = threadIdx.x; q < total; q += kThreads) {
      const int rr = q / row_elems;
      const int k = q - rr * row_elems;
      const int r = r_from + rr;
      ring[(r % H) * row_elems + k] = src[r * row_elems + k];
    }
  }
}

// Block-wide min and max into lo[0] and hi[0]: one shared atomic per warp.
__device__ __forceinline__ void block_minmax(int vmin, int vmax, int* lo, int* hi) {
  vmin = __reduce_min_sync(0xffffffffu, vmin);
  vmax = __reduce_max_sync(0xffffffffu, vmax);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(lo, vmin);
    atomicMax(hi, vmax);
  }
}

// VEC_IN: patch rows are whole 16-byte chunks. FAST_X: C == 3 and crop rows
// are whole 16-byte chunks (8 values per x-pass work item).
template <bool VEC_IN, bool FAST_X>
__global__ void __launch_bounds__(kThreads, 2) shear_rotate(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, E = a.E, C = a.C, H = a.ring_rows, tp = a.t_pitch;
  constexpr int CC = FAST_X ? 3 : kMaxC;  // channels the y pass unrolls
  const int row_elems = P * C;
  const int n = blockIdx.x / a.segments;
  const int seg = blockIdx.x - n * a.segments;
  const int off = (P - E) / 2;
  const int i_begin = seg * E / a.segments, i_end = (seg + 1) * E / a.segments;
  const int tid = threadIdx.x;

  u16* ring = reinterpret_cast<u16*>(smem);
  u16* tb = reinterpret_cast<u16*>(smem + align16(size_t(H) * row_elems * 2));
  XTap* xtap = reinterpret_cast<XTap*>(reinterpret_cast<unsigned char*>(tb) +
                                       align16(size_t(a.band_rows) * tp * 2));  // by crop row
  YTap* ytap = reinterpret_cast<YTap*>(xtap + E);
  int* red = reinterpret_cast<int*>(ytap + P);  // ox min, ox max, oy min, oy max

  const u16* src = a.patches + size_t(n) * P * row_elems;
  u16* dst = a.out + size_t(n) * E * E * C;

  if (tid == 0) {
    red[0] = INT_MAX;
    red[1] = INT_MIN;
    red[2] = INT_MAX;
    red[3] = INT_MIN;
  }
  __syncthreads();

  // line taps: the P column lines of the y pass, the kept row lines of the x pass
  const float half = (P - 1) * 0.5f;
  const float sy = a.slope_y[n], cy = a.const_y[n], sx = a.slope_x[n], cx = a.const_x[n];
  int omin = INT_MAX, omax = INT_MIN;
  for (int l = tid; l < P + (i_end - i_begin); l += kThreads) {
    int o;
    u16 w0, w1;
    if (l < P) {
      line_tap(sy, cy, __fsub_rn((float)l, half), (float)-a.ky, a.ky - 1.0f, &o, &w0, &w1);
      ytap[l] = YTap{o, w0 | (unsigned)w1 << 16};
    } else {
      const int i = i_begin + l - P;
      line_tap(sx, cx, __fsub_rn((float)(off + i), half), (float)-a.kx, a.kx - 1.0f, &o, &w0,
               &w1);
      const int base = (off + o + a.pad_l) * C;
      const int shift = FAST_X ? -base & 7 : 0;
      xtap[i] = XTap{base + shift, (off + o) * 8 + shift, w0 | (unsigned)w0 << 16,
                     w1 | (unsigned)w1 << 16};
      omin = min(omin, o);
      omax = max(omax, o);
    }
  }
  block_minmax(omin, omax, &red[0], &red[1]);
  __syncthreads();
  // the columns of t the x pass reads, and the rows the y pass reads for them
  const int xl = off + red[0], xr = off + E + red[1] + 1;
  int ymin = INT_MAX, ymax = INT_MIN;
  for (int x = max(0, xl) + tid; x < min(P, xr); x += kThreads) {
    ymin = min(ymin, ytap[x].off);
    ymax = max(ymax, ytap[x].off);
  }
  block_minmax(ymin, ymax, &red[2], &red[3]);
  __syncthreads();
  const bool any = max(0, xl) < min(P, xr);
  const int lo = any ? red[2] : 0;
  const int hi = any ? red[3] + 1 : 0;
  const int band = H >= P ? a.band_rows : min(a.band_rows, H - (hi - lo));
  if (band < 1) __trap();  // the launcher sizes H >= 2*ky + 2 > hi - lo

  const int y_begin = off + i_begin, y_end = off + i_end;
  const int seg_hi = min(P - 1, y_end - 1 + hi);  // last patch row the segment reads
  int issued = max(0, y_begin + lo) - 1;          // last patch row requested
  {
    const int need_hi = min(P - 1, y_begin + min(band, y_end - y_begin) - 1 + hi);
    load_rows<VEC_IN>(ring, src, issued + 1, need_hi, H, row_elems);
    issued = max(issued, need_hi);
    cp_async_commit();
    const int ahead = min(seg_hi, max(0, y_begin + lo) + H - 1);
    load_rows<VEC_IN>(ring, src, issued + 1, ahead, H, row_elems);
    issued = max(issued, ahead);
    cp_async_commit();
  }

  for (int y0 = y_begin; y0 < y_end; y0 += band) {
    const int rows = min(band, y_end - y0);
    const int i0 = y0 - off;  // crop row of band row 0
    cp_async_wait<1>();       // all but the newest group: this band's rows are in
    __syncthreads();

    // ---- y pass: each item walks one column's C values down kChunk rows ----
    const int nlo = max(0, y0 + lo);
    const int origin = nlo - nlo % H;  // ring slot of row r: r - origin, less H past the end
    const int chunks = (rows + kChunk - 1) / kChunk;
    // the band's t columns: a row's offset is monotonic in the row, so the
    // band's first and last rows bound them
    const int bl = min(xtap[i0].col, xtap[i0 + rows - 1].col) >> 3;
    const int W = (max(xtap[i0].col, xtap[i0 + rows - 1].col) >> 3) + E + 1 - bl;
    const int step_c = kThreads / W, step_x = kThreads - step_c * W;
    int ck = tid / W, col = tid - ck * W;  // item q: chunk q / W, column bl + q % W
    for (int q = tid; q < chunks * W; q += kThreads) {
      const int x = bl + col;
      const int j0 = ck * kChunk, nj = min(kChunk, rows - j0);
      u16* tcol = tb + j0 * tp + (x + a.pad_l) * C;  // in t row j0, before its shift
      const XTap* xt = xtap + i0 + j0;
      int sh[kChunk];  // the shifts of the item's t rows (x-pass reads start on 16 bytes)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) sh[j] = j < nj ? xt[j].col & 7 : 0;
      if (x < 0 || x >= P) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int ch = 0; ch < CC; ++ch)
            if (j < nj && ch < C) tcol[j * tp + sh[j] + ch] = 0;
      } else {
        const YTap t = ytap[x];
        const u16 w0 = t.w & 0xffff, w1 = t.w >> 16;
        const u16* cb = ring + x * C;
        const int ys = y0 + j0 + t.off;  // patch row of the item's first tap
        int s = ys - origin;
        s -= s >= H ? H : 0;
        // every patch value first, so the reads are in flight together
        u16 v[kChunk + 1][CC];
#pragma unroll
        for (int j = 0; j <= kChunk; ++j) {
          const bool ok = j <= nj && ys + j >= 0 && ys + j < P;
#pragma unroll
          for (int ch = 0; ch < CC; ++ch) v[j][ch] = ok && ch < C ? cb[s * row_elems + ch] : 0;
          s += s + 1 >= H ? 1 - H : 1;
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int ch = 0; ch < CC; ++ch)
            if (j < nj && ch < C)
              tcol[j * tp + sh[j] + ch] = add1(mul1(w0, v[j][ch]), mul1(w1, v[j + 1][ch]));
      }
      col += step_x;
      ck += step_c;
      if (col >= W) {
        col -= W;
        ++ck;
      }
    }
    __syncthreads();

    // ---- next rows into the ring while the x pass runs ---------------------
    const int y1 = y0 + band;
    if (y1 < y_end) {
      const int need_hi = min(P - 1, y1 + min(band, y_end - y1) - 1 + hi);
      load_rows<VEC_IN>(ring, src, issued + 1, need_hi, H, row_elems);
      issued = max(issued, need_hi);
    }
    cp_async_commit();
    {
      const int ahead = min(seg_hi, max(0, y1 + lo) + H - 1);
      load_rows<VEC_IN>(ring, src, issued + 1, ahead, H, row_elems);
      issued = max(issued, ahead);
    }
    cp_async_commit();

    // ---- x pass ------------------------------------------------------------
    if (FAST_X) {  // 8 crop values per item: two 16-byte reads, one 16-byte store
      const int groups = E * 3 / 8;
      const int step_j = kThreads / groups, step_g = kThreads - step_j * groups;
      int j = tid / groups, g = tid - j * groups;  // item q: row q / groups, group q % groups
      for (int q = tid; q < rows * groups; q += kThreads) {
        const XTap t = xtap[i0 + j];
        const u16* tr = tb + j * tp + t.read + g * 8;
        const uint4 v0 = *reinterpret_cast<const uint4*>(tr);
        const uint4 v1 = *reinterpret_cast<const uint4*>(tr + 8);
        // first tap: values 0..7; second tap: values 3..10, straddling words
        uint4 o;
        o.x = add2(mul2(t.w0, v0.x), mul2(t.w1, __byte_perm(v0.y, v0.z, 0x5432)));
        o.y = add2(mul2(t.w0, v0.y), mul2(t.w1, __byte_perm(v0.z, v0.w, 0x5432)));
        o.z = add2(mul2(t.w0, v0.z), mul2(t.w1, __byte_perm(v0.w, v1.x, 0x5432)));
        o.w = add2(mul2(t.w0, v0.w), mul2(t.w1, __byte_perm(v1.x, v1.y, 0x5432)));
        *reinterpret_cast<uint4*>(dst + size_t(i0 + j) * E * 3 + g * 8) = o;
        g += step_g;
        j += step_j;
        if (g >= groups) {
          g -= groups;
          ++j;
        }
      }
    } else {
      const int per_row = E * C;
      for (int q = tid; q < rows * per_row; q += kThreads) {
        const int j = q / per_row;
        const int k = q - j * per_row;
        const XTap t = xtap[i0 + j];
        const u16* tr = tb + j * tp + t.read + k;
        dst[size_t(i0 + j) * per_row + k] =
            add1(mul1(t.w0 & 0xffff, tr[0]), mul1(t.w1 & 0xffff, tr[C]));
      }
    }
  }
  cp_async_wait<0>();
}

template <bool VEC_IN, bool FAST_X>
cudaError_t launch(const Params& a, int blocks, size_t smem, int dev, cudaStream_t stream) {
  // the opt-in above 48 KB holds per device: one attribute call per instance
  // and device (every launch on devices past the 64th)
  static unsigned long long opted_in = 0;
  const unsigned long long bit = dev >= 0 && dev < 64 ? 1ull << dev : 0;
  auto kern = shear_rotate<VEC_IN, FAST_X>;
  if (!(opted_in & bit)) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemPerBlock);
    if (e != cudaSuccess) return e;
    opted_in |= bit;
  }
  kern<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// patches [N, P, P, C] bf16; slope_y, const_y, slope_x, const_x [N] f32
// (warp_fast._shear_params); ky, kx the static windows; out [N, E, E, C]
// bf16. `segments` (1..E) and `blocks_per_sm` (1 or 2) force the tiling, 0
// leaves each to the launcher. Launches on the current device. Returns a
// cudaError_t code.
extern "C" int shear_rotate_launch(const void* patches, const void* slope_y, const void* const_y,
                                   const void* slope_x, const void* const_x, int N, int P, int E,
                                   int C, int ky, int kx, int segments, int blocks_per_sm,
                                   void* out, void* stream) {
  if (N <= 0) return 0;
  if (P <= 0 || E <= 0 || E > P || C <= 0 || C > kMaxC || ky < 0 || kx < 0 || segments < 0 ||
      segments > E || blocks_per_sm < 0 || blocks_per_sm > 2)
    return (int)cudaErrorInvalidValue;
  Params a;
  a.patches = static_cast<const u16*>(patches);
  a.slope_y = static_cast<const float*>(slope_y);
  a.const_y = static_cast<const float*>(const_y);
  a.slope_x = static_cast<const float*>(slope_x);
  a.const_x = static_cast<const float*>(const_x);
  a.out = static_cast<u16*>(out);
  a.P = P;
  a.E = E;
  a.C = C;
  a.ky = ky;
  a.kx = kx;
  const int row_elems = P * C;
  const size_t row_bytes = size_t(row_elems) * 2;
  const bool vec_in = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(patches) % 16 == 0;
  const bool fast_x = C == 3 && (E * C) % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int off = (P - E) / 2;
  a.pad_l = kx > off ? kx - off : 0;
  const int pad_r = off + E + kx + 1 > P ? off + E + kx + 1 - P : 0;
  // room for the row shift (< 8) and the fast x pass's last 16-byte read
  a.t_pitch = ((a.pad_l + P + pad_r) * C + 16 + 7) / 8 * 8;

  // the largest ring that fits: two blocks per SM if the window allows,
  // else one; the band as tall as the ring leaves room for
  const int min_ring = 2 * ky + 2;
  size_t smem = 0;
  int bps = 0;
  for (int b = blocks_per_sm ? blocks_per_sm : 2; b >= (blocks_per_sm ? blocks_per_sm : 1) && !bps;
       --b) {
    const size_t budget = b == 2 ? kSmemPerSm / 2 - kSmemReserved : kSmemPerBlock;
    for (int r = kMaxBand; r >= 1; --r) {
      const size_t fixed = align16(size_t(r) * a.t_pitch * 2) + align16(taps_bytes(P, E));
      if (fixed + row_bytes > budget) continue;
      int h = (int)((budget - fixed) / row_bytes);
      if (h > P) h = P;
      while (h > 0 && align16(size_t(h) * row_bytes) + fixed > budget) --h;
      if (h >= P || h >= min_ring) {
        a.ring_rows = h;
        a.band_rows = r;
        smem = align16(size_t(h) * row_bytes) + fixed;
        bps = b;
        break;
      }
    }
  }
  if (!bps) return (int)cudaErrorInvalidValue;  // a window too tall for shared memory

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // segments per patch: the fewest rows loaded per wave slot, as each
  // segment loads its crop rows plus the window again
  const long slots = long(bps) * (sms > 0 ? sms : 1);
  long best = -1;
  a.segments = segments;
  for (int g = 1; !segments && g <= 8 && g <= E; ++g) {
    const long waves = (long(N) * g + slots - 1) / slots;
    const long cost = waves * ((E + g - 1) / g + 2L * ky);
    if (best < 0 || cost < best) {
      best = cost;
      a.segments = g;
    }
  }
  const long blocks = long(N) * a.segments;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (vec_in)
    return (int)(fast_x ? launch<true, true>(a, nb, smem, dev, s)
                        : launch<true, false>(a, nb, smem, dev, s));
  return (int)(fast_x ? launch<false, true>(a, nb, smem, dev, s)
                      : launch<false, false>(a, nb, smem, dev, s));
}
