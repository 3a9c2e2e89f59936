// IResNet's BatchNorms, PReLU and residual add as one pass over a map.
//
// Replaces no Pallas kernel: the JAX package has no IResNet. The port's
// IResNet (facerec_torch/models/iresnet.py) runs insightface's block,
//   bn1 -> conv1 -> bn2 -> prelu -> conv2 (strided) -> bn3, + identity or
//   downsample (1 x 1 conv, BatchNorm),
// and served in eval mode each BatchNorm, the PReLU and the add is a PyTorch
// elementwise kernel that reads and writes a whole bf16 map: about 250
// launches and 37 GB an embed of 384 crops at 112 px, more device time than
// the convolutions between them. On the fused route cuDNN keeps the
// convolutions and this kernel does the rest in two passes a block:
//   pass A, after conv1:  d = prelu(bn2(y));
//   pass B, after conv2 and the shortcut's conv:
//     z = bn3(e) + (x | bn_ds(g)), and in the same pass the next block's
//     bn1(z) (the head's bn2(z) after the last block, which writes only that);
// the stem's pass writes prelu(bn1(conv1)) and layer1.0's bn1 of it.
//
// Arithmetic, op for op the unfused chain's on the card, so each output is
// the module chain's bit for bit. PyTorch's eval BatchNorm over a
// channels_last bf16 map (batch_norm_transform_input_channels_last_kernel,
// ATen/native/cuda/Normalization.cuh) computes in f32
//   y = w * (x - mean) * invstd + b,   invstd = rsqrtf(var + eps)
// with w, b, mean and var the module's bf16 parameters and running
// statistics read as f32; nvcc contracts the last product and the sum into
// one FMA, written here as __fmaf_rn(__fmul_rn(w, x - mean), invstd, b). The
// result is stored as bf16 (round to nearest even). PReLU is
// x > 0 ? x : bf16(slope * x) and the add bf16(a + b), both on bf16 values,
// as PyTorch's kernels compute them. Nothing is computed below f32, and every
// value is rounded to bf16 where the unfused chain stores a bf16 tensor.
//
// Bound on the H100: bytes. A pass reads one or two bf16 maps and writes one
// or two; a dozen f32 operations a value do not count against 3.35 TB/s.
// Over an embed of 384 crops the 99 passes move about 19.7 GB, against 37.2
// GB for the unfused chain.
//
// Design. A map is [M, C] in memory (channels_last), C a multiple of 8 up to
// kMaxC. A thread moves 16-byte vectors: 8 channels of one pixel. A block's
// thread count is a multiple of the C / 8 vectors of a pixel, and the grid a
// few waves of the SMs walks the map in a grid-stride loop, so a thread meets
// the same 8 channels at every step and reads their parameters from shared
// memory once a step for its kUnroll vectors. At its start each block
// computes every channel's w, mean, invstd and b (and slope) in f32 from the
// modules' own tensors, read in place at every launch: a captured CUDA graph
// that replays the pass sees an edited parameter or running statistic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // at most, a block
constexpr int kMaxC = 512;        // channels, the shared memory's parameters
constexpr int kVec = 8;           // bf16 channels a 16-byte vector
constexpr int kUnroll = 4;        // vectors a thread loads before it computes
constexpr int kMaxDevices = 64;

struct Bn {  // a BatchNorm2d's bf16 tensors [C] and its eps; w null: absent
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;
  const __nv_bfloat16* mean;
  const __nv_bfloat16* var;
  float eps;
};

struct Params {
  const uint4* a;   // [M, C] bf16: the conv's output
  const uint4* r;   // [M, C] bf16 or null: the shortcut (identity, or its conv's output)
  uint4* z;         // [M, C] bf16 or null: the pass's output
  uint4* zn;        // [M, C] bf16 or null: bn_n of that output
  long long vecs;   // M * C / 8
  int c;
  Bn bn_a, bn_r, bn_n;
  const __nv_bfloat16* slope;  // the PReLU's [C] weights
};

// a channel's parameters in f32: w, mean, invstd, b
enum { kW = 0, kMean = 1, kInv = 2, kB = 3, kFields = 4 };

__device__ __forceinline__ float bf(const __nv_bfloat16* p, int c) {
  return __bfloat162float(p[c]);
}

__device__ __forceinline__ void load_bn(float (*s)[kMaxC], const Bn& bn, int c) {
  s[kW][c] = bf(bn.w, c);
  s[kMean][c] = bf(bn.mean, c);
  s[kInv][c] = rsqrtf(__fadd_rn(bf(bn.var, c), bn.eps));
  s[kB][c] = bf(bn.b, c);
}

// 8 consecutive f32 values of shared memory, from two 16-byte reads
__device__ __forceinline__ void load8(const float* s, float* out) {
  const float4 lo = *reinterpret_cast<const float4*>(s);
  const float4 hi = *reinterpret_cast<const float4*>(s + 4);
  out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
  out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
}

struct Chan8 {  // one BatchNorm's parameters of a thread's 8 channels
  float w[kVec], mean[kVec], inv[kVec], b[kVec];
};

__device__ __forceinline__ Chan8 chan8(float (*s)[kMaxC], int c0) {
  Chan8 q;
  load8(&s[kW][c0], q.w);
  load8(&s[kMean][c0], q.mean);
  load8(&s[kInv][c0], q.inv);
  load8(&s[kB][c0], q.b);
  return q;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's eval BatchNorm of one value, rounded to bf16 as it stores it
__device__ __forceinline__ float batch_norm(const Chan8& q, int e, float x) {
  return round_bf16(__fmaf_rn(__fmul_rn(q.w[e], __fsub_rn(x, q.mean[e])), q.inv[e], q.b[e]));
}

__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  const unsigned* w = reinterpret_cast<const unsigned*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* x) {
  uint4 v;
  unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  return v;
}

// kShortcut: 0 none, 1 the identity, 2 through bn_r
template <bool kPrelu, int kShortcut>
__global__ void __launch_bounds__(kThreads, 2) iresnet_epilogue(const Params p) {
  __shared__ __align__(16) float s_bn[3][kFields][kMaxC];  // bn_a, bn_r, bn_n
  __shared__ __align__(16) float s_slope[kMaxC];
  const int C = p.c;
  const bool next = p.zn != nullptr;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    load_bn(s_bn[0], p.bn_a, c);
    if (kShortcut == 2) load_bn(s_bn[1], p.bn_r, c);
    if (next) load_bn(s_bn[2], p.bn_n, c);
    if (kPrelu) s_slope[c] = bf(p.slope, c);
  }
  __syncthreads();

  // blockDim.x and so the grid's stride are multiples of C / 8: a thread's
  // vectors all hold channels c0 .. c0 + 7
  const int c0 = (threadIdx.x % (C / kVec)) * kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; v0 < p.vecs;
       v0 += kUnroll * stride) {
    uint4 av[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      av[u] = rv[u] = make_uint4(0, 0, 0, 0);  // past the end: computed, not stored
      if (v < p.vecs) {
        av[u] = __ldcs(p.a + v);
        if (kShortcut) rv[u] = __ldcs(p.r + v);
      }
    }
    float y[kUnroll][kVec];
    {
      const Chan8 q = chan8(s_bn[0], c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unpack(av[u], y[u]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) y[u][e] = batch_norm(q, e, y[u][e]);
      }
    }
    if (kPrelu) {
      float s[kVec];
      load8(&s_slope[c0], s);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          y[u][e] = y[u][e] > 0.0f ? y[u][e] : round_bf16(__fmul_rn(s[e], y[u][e]));
    }
    if (kShortcut) {
      Chan8 q;
      if (kShortcut == 2) q = chan8(s_bn[1], c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float r[kVec];
        unpack(rv[u], r);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float re = kShortcut == 2 ? batch_norm(q, e, r[e]) : r[e];
          y[u][e] = round_bf16(__fadd_rn(y[u][e], re));
        }
      }
    }
    if (p.z) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * stride;
        if (v < p.vecs) p.z[v] = pack(y[u]);
      }
    }
    if (next) {
      const Chan8 q = chan8(s_bn[2], c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + u * stride;
        if (v < p.vecs) {
          float o[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) o[e] = batch_norm(q, e, y[u][e]);
          p.zn[v] = pack(o);
        }
      }
    }
  }
}

template <bool kPrelu, int kShortcut>
cudaError_t launch(const Params& p, int threads, int sms, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks an SM, the same on every card of a process
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, iresnet_epilogue<kPrelu, kShortcut>, threads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long per_block = (long long)threads * kUnroll;
  long long blocks = (p.vecs + per_block - 1) / per_block;
  const long long wave = (long long)sms * per_sm;
  if (blocks > wave) blocks = wave;
  iresnet_epilogue<kPrelu, kShortcut><<<(int)blocks, threads, 0, stream>>>(p);
  return cudaGetLastError();
}

int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms[dev];
}

Bn bn_of(const void* const* t, float eps) {
  Bn bn;
  bn.w = static_cast<const __nv_bfloat16*>(t[0]);
  bn.b = static_cast<const __nv_bfloat16*>(t[1]);
  bn.mean = static_cast<const __nv_bfloat16*>(t[2]);
  bn.var = static_cast<const __nv_bfloat16*>(t[3]);
  bn.eps = eps;
  return bn;
}

}  // namespace

// a, r, z, zn: [M, C] bf16 maps, 16-byte aligned (r, z or zn null where the
// pass has none; not both z and zn). bns: 12 pointers, the weight, bias,
// running mean and running variance ([C] bf16) of bn_a, bn_r and bn_n, null
// where that BatchNorm is absent (bn_r without r is refused; bn_n present
// exactly when zn is); eps: their 3 eps. slope: the PReLU's [C] bf16 weights
// or null. C a multiple of 8, at most 512. Launches on the current device's
// given stream. Returns a cudaError_t code.
extern "C" int iresnet_epilogue_launch(const void* a, const void* r, void* z, void* zn,
                                       long long m, int c, const void* const* bns,
                                       const float* eps, const void* slope, void* stream) {
  if (m < 0 || c <= 0 || c % kVec || c > kMaxC || !a || (!z && !zn))
    return (int)cudaErrorInvalidValue;
  if (!bns[0] || (bns[4] && !r) || (bns[8] == nullptr) != (zn == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Params p;
  p.a = static_cast<const uint4*>(a);
  p.r = static_cast<const uint4*>(r);
  p.z = static_cast<uint4*>(z);
  p.zn = static_cast<uint4*>(zn);
  p.vecs = m * (c / kVec);
  p.c = c;
  p.bn_a = bn_of(bns, eps[0]);
  p.bn_r = bn_of(bns + 4, eps[1]);
  p.bn_n = bn_of(bns + 8, eps[2]);
  p.slope = static_cast<const __nv_bfloat16*>(slope);
  const int groups = c / kVec;
  const int threads = kThreads - kThreads % groups;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shortcut = r == nullptr ? 0 : bns[4] == nullptr ? 1 : 2;
  if (slope) {
    switch (shortcut) {
      case 0: return (int)launch<true, 0>(p, threads, sms, s);
      case 1: return (int)launch<true, 1>(p, threads, sms, s);
      default: return (int)launch<true, 2>(p, threads, sms, s);
    }
  }
  switch (shortcut) {
    case 0: return (int)launch<false, 0>(p, threads, sms, s);
    case 1: return (int)launch<false, 1>(p, threads, sms, s);
    default: return (int)launch<false, 2>(p, threads, sms, s);
  }
}
