// Crop-and-resize of axis-aligned boxes: each output value from two taps of
// the source per axis.
//
// Replaces no Pallas kernel. The JAX package computes this function with two
// jnp matmuls against bilinear weight matrices
// (facerec_tpu/ops/warp_fast.py::crop_resize_matmul), which suits the TPU's
// matrix unit; the port's plain version does the same
// (facerec_torch/ops/warp_fast.py::crop_resize_matmul_batched). On this card
// that shape is wrong twice over: torch.matmul broadcasts the frame over the
// boxes and writes a copy of it per box, and each weight row has at most two
// nonzeros in its 24 to 640 entries, so over 99% of the f32 GEMMs' products
// multiply zeros. The serve step's three calls (R-Net 48 x 32 crops of 24 px
// from a 288 x 384 f32 frame, O-Net 48 x 20 of 48 px from the 480 x 640 bf16
// frame, align 48 x 8 patches of 208 px from the 480 x 640 f32 frame) wrote
// 7 GB of frame copies and ran about 330 GFLOP a request.
//
// Arithmetic, bit for bit with the matmul route on the card. For each output
// line the kernel computes, op by op as crop_kernel.crop_taps states it,
//   s   = clamp(x2 - x1, min=1) / out        (per axis)
//   pos = clamp(start + s * p, 0, in - 1)
//   taps floor(pos) and floor(pos) + 1, each weight bf16(max(1 - |pos - s|, 0)),
//   the second read at the first past the edge (its weight is 0 there),
// with __fmul_rn / __fadd_rn / __fsub_rn, so that nvcc contracts nothing into
// an FMA, as PyTorch's separate elementwise kernels round each step. PyTorch
// on CUDA divides a tensor by a host scalar as a product with the scalar's f32
// reciprocal, so s is (x2 - x1) * (1.0f / out). The source is rounded to bf16
// as it is read. The row pass is t = bf16(wy0 * src[y0, x] + wy1 * src[y1, x])
// at the two source columns an output column needs, the column pass
// wx0 * t0 + wx1 * t1 in f32 from a +0 start, cast to the output type. All
// weights and source values are bf16, so each product is exact in f32, and the
// GEMMs' sums of two nonzero products and exact zeros round as these sums do,
// in whatever order or split they add them. A NaN position (a box with a
// non-finite coordinate) gives NaN weights, and NaN on its row or column, as
// the matmul does. A source value that is not finite is read only at its own
// taps; the matmul spreads it over every crop of its frame.
//
// Bound on the H100: bytes. A call writes B*N*out*out*C output values and
// reads the source pixels the crops reach and 16 bytes of box per crop; it
// computes a dozen f32 operations per output value. The align call writes
// 99.7 MB (384 x 208 x 208 x 3 bf16), the O-Net call 13.3 MB, the R-Net call
// 5.3 MB, each a few tens of microseconds at 3.35 TB/s.
//
// Design. A block owns one crop, or one of `segments` row ranges of it. It
// computes the taps of every output column and of its rows once into shared
// memory, then its threads walk the range's output values in vectors of 16
// bytes (8 bf16 or 4 f32 values of one row), neighbouring threads on
// neighbouring vectors, so that stores are whole and coalesced and the source
// reads of a warp fall on a few neighbouring pixels, which L1 serves. The
// launcher cuts a crop into as many row ranges as give each thread about
// kVecsPerThread vectors: the 208 px patches into 8, the 24 and 48 px crops
// not at all. A row of the output is a whole number of vectors (out * C a
// multiple of 8 bf16 or 4 f32 values: 24 and 48 px crops and align's patches,
// a multiple of 8 px, of 3 channels); the wrapper refuses other shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;
constexpr int kVecsPerThread = 8;     // vectors a thread writes in a block, about
constexpr size_t kMaxSmem = 48 * 1024;  // the taps, without the opt-in

struct Tap {  // one output line: source indices and bf16 weights (as f32)
  int i0, i1;
  float w0, w1;
};

struct Params {
  const void* src;     // [B, H, W, C] f32 or bf16
  const float* boxes;  // [B * N, 4] x1, y1, x2, y2
  void* out;           // [B * N, P, P, C] f32 or bf16
  int N, H, W, C, P;
  int segments;  // row ranges of a crop, one block each
  float inv_p;   // 1.0f / P
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.clamp's NaN rule: a NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// the weight of tap s for position pos: bf16(max(1 - |pos - s|, 0))
__device__ __forceinline__ float tap_weight(float pos, float s) {
  return bf16_round(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, s))), 0.0f));
}

// Output line p of one axis, as crop_kernel.crop_taps.
__device__ __forceinline__ Tap line_tap(float start, float scale, int p, int n_in) {
  const float hi = (float)(n_in - 1);
  const float pos = clamp_nan(__fadd_rn(start, __fmul_rn(scale, (float)p)), 0.0f, hi);
  Tap t;
  if (pos != pos) {
    t.i0 = t.i1 = 0;
    t.w0 = t.w1 = pos;
    return t;
  }
  const float s0 = floorf(pos);
  const float s1 = __fadd_rn(s0, 1.0f);
  t.i0 = (int)s0;
  t.i1 = s1 > hi ? t.i0 : (int)s1;  // past the edge pos == in - 1, so w1 == 0
  t.w0 = tap_weight(pos, s0);
  t.w1 = tap_weight(pos, s1);
  return t;
}

// the box's scale on one axis: clamp(hi - lo, min=1) / P as PyTorch computes it on CUDA
__device__ __forceinline__ float axis_scale(float lo, float hi, float inv_p) {
  const float d = __fsub_rn(hi, lo);
  return __fmul_rn(d != d ? d : fmaxf(d, 1.0f), inv_p);
}

__device__ __forceinline__ float load_bf(const float* p) { return bf16_round(__ldg(p)); }

__device__ __forceinline__ float load_bf(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// 16 bytes of output: 4 f32 or 8 bf16 values
template <typename OutT>
constexpr int kVec = sizeof(OutT) == 2 ? 8 : 4;

__device__ __forceinline__ void store(float* dst, const float* o) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* dst, const float* o) {
  uint4 v;
  unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
    w[e] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// kVec<OutT> output values per work item, all in one row (it divides P * C).
template <typename SrcT, typename OutT>
__global__ void __launch_bounds__(kThreads) crop_resize(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, C = a.C, W = a.W;
  const int crop = blockIdx.x / a.segments;
  const int seg = blockIdx.x - crop * a.segments;
  const int r_begin = seg * P / a.segments;
  const int rows = (seg + 1) * P / a.segments - r_begin;
  Tap* xt = reinterpret_cast<Tap*>(smem);  // the P output columns
  Tap* yt = xt + P;                        // the range's output rows

  const float* box = a.boxes + size_t(crop) * 4;
  const float x1 = box[0], y1 = box[1], x2 = box[2], y2 = box[3];
  const float sx = axis_scale(x1, x2, a.inv_p);
  const float sy = axis_scale(y1, y2, a.inv_p);
  for (int l = threadIdx.x; l < P + rows; l += kThreads) {
    if (l < P)
      xt[l] = line_tap(x1, sx, l, W);
    else
      yt[l - P] = line_tap(y1, sy, r_begin + l - P, a.H);
  }
  __syncthreads();

  const int frame = crop / a.N;
  const int row_elems = P * C;
  const size_t src_row = size_t(W) * C;
  const SrcT* src = static_cast<const SrcT*>(a.src) + size_t(frame) * a.H * src_row;
  OutT* dst = static_cast<OutT*>(a.out) + (size_t(crop) * P + r_begin) * row_elems;
  constexpr int VEC = kVec<OutT>;
  const int per_row = row_elems / VEC;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int j = v / per_row;
    const int k0 = (v - j * per_row) * VEC;
    const Tap ty = yt[j];
    const SrcT* r0 = src + ty.i0 * src_row;
    const SrcT* r1 = src + ty.i1 * src_row;
    int q = k0 / C, c = k0 - q * C;
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const Tap tx = xt[q];
      const int a0 = tx.i0 * C + c, a1 = tx.i1 * C + c;
      const float t0 = bf16_round(__fadd_rn(__fadd_rn(0.0f, __fmul_rn(ty.w0, load_bf(r0 + a0))),
                                            __fmul_rn(ty.w1, load_bf(r1 + a0))));
      const float t1 = bf16_round(__fadd_rn(__fadd_rn(0.0f, __fmul_rn(ty.w0, load_bf(r0 + a1))),
                                            __fmul_rn(ty.w1, load_bf(r1 + a1))));
      o[e] = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(tx.w0, t0)), __fmul_rn(tx.w1, t1));
      if (++c == C) {
        c = 0;
        ++q;
      }
    }
    store(dst + size_t(j) * row_elems + k0, o);
  }
}

template <typename SrcT, typename OutT>
cudaError_t launch(const Params& a, int blocks, size_t smem, cudaStream_t stream) {
  crop_resize<SrcT, OutT><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// src [B, H, W, C] f32 (src_bf16 0) or bf16 (1), contiguous; boxes [B, N, 4]
// f32 (x1, y1, x2, y2); out [B, N, P, P, C] f32 (out_bf16 0) or bf16 (1),
// P * C a multiple of 4 (f32) or 8 (bf16). Launches on the current device.
// Returns a cudaError_t code.
extern "C" int crop_resize_launch(const void* src, int src_bf16, const void* boxes, int B, int N,
                                  int H, int W, int C, int P, void* out, int out_bf16,
                                  void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (H <= 0 || W <= 0 || P <= 0 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (long(W) * C > INT_MAX / 2 || long(P) * C > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  Params a;
  a.src = src;
  a.boxes = static_cast<const float*>(boxes);
  a.out = out;
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.P = P;
  a.inv_p = 1.0f / (float)P;
  const int vec = out_bf16 ? kVec<__nv_bfloat16> : kVec<float>;
  if ((P * C) % vec != 0) return (int)cudaErrorInvalidValue;
  const long per_crop = long(P) * (P * C / vec);
  const long per_block = long(kThreads) * kVecsPerThread;
  long segments = (per_crop + per_block - 1) / per_block;
  a.segments = (int)(segments < 1 ? 1 : segments > P ? P : segments);
  const size_t smem = size_t(P + (P + a.segments - 1) / a.segments) * sizeof(Tap);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long blocks = long(B) * N * a.segments;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (src_bf16)
    return (int)(out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, nb, smem, s)
                          : launch<__nv_bfloat16, float>(a, nb, smem, s));
  return (int)(out_bf16 ? launch<float, __nv_bfloat16>(a, nb, smem, s)
                        : launch<float, float>(a, nb, smem, s));
}
