// 2-shear patch rotation: a y-shear then an x-shear of each bf16 patch,
// writing only the centred E x E crop.
//
// Replaces the Pallas kernel facerec_tpu/ops/pallas_warp.py::_rotate_kernel
// (launched by rotate_patches_pallas). The two shears are the LDU remainder
// of the eye-levelling rotation (facerec_torch/ops/warp_fast.py
// _shear_params). Each shear moves every line (a column for the y pass, a
// row for the x pass) by its own shift; the TPU kernel realises the shift as
// a coarse one-hot translate at granularity 8 followed by a 9-tap fine
// pass. Because the coarse slots are one-hot and only two fine taps carry
// weight, each line reduces to one integer offset o and two bf16 weights
// (w0, w1), computed in PyTorch from the same f32 line arithmetic as the
// plain version (facerec_torch/ops/warp_kernel.py):
//
//   y pass:  t[y, x]  = w0y[x] * p[y + oy[x], x] + w1y[x] * p[y + oy[x] + 1, x]
//   x pass:  o[y, x]  = w0x[y] * t[y, x + ox[y]] + w1x[y] * t[y, x + ox[y] + 1]
//
// with zeros outside the patch. Each product and each sum is rounded to
// bf16 in the order the plain version adds its taps, so the kernel matches
// it up to last-ulp differences.
//
// Design: one thread per output element (patch, row, column, channel) of
// the crop, channels innermost so neighbouring threads write neighbouring
// bytes. A thread evaluates the two x taps it needs; each is a y-pass value,
// which is two reads of the input patch. Nothing is staged in shared memory:
// the Pallas layout keeps one whole patch resident per program, and a
// 208 x 208 x 3 bf16 patch (259,584 B) is more than the 232,448 B one H100
// block can hold. The re-reads of neighbouring pixels hit L1/L2.
//
// Bound on the H100: bytes. The kernel must read N*P*P*C*2 bytes of patches
// and write N*E*E*C*2 bytes of crops; its arithmetic (a dozen flops per
// output) is far below the card's balance point.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void shear_rotate(const __nv_bfloat16* __restrict__ patches,
                             const int* __restrict__ oy, const __nv_bfloat16* __restrict__ wy,
                             const int* __restrict__ ox, const __nv_bfloat16* __restrict__ wx,
                             int N, int P, int E, int C, __nv_bfloat16* __restrict__ out) {
  const int64_t total = (int64_t)N * E * E * C;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = (int)(t % C);
  const int j = (int)((t / C) % E);
  const int i = (int)((t / ((int64_t)C * E)) % E);
  const int n = (int)(t / ((int64_t)C * E * E));
  const int off = (P - E) / 2;
  const int y = off + i, x = off + j;
  const __nv_bfloat16* pn = patches + (int64_t)n * P * P * C;
  const int line_x = n * P + y;  // x-pass line: the row
  const int o = ox[line_x];
  const float w0 = __bfloat162float(wx[2 * line_x]);
  const float w1 = __bfloat162float(wx[2 * line_x + 1]);
  float tv[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int xs = x + o + a;
    float v = 0.f;
    if (xs >= 0 && xs < P) {
      const int line_y = n * P + xs;  // y-pass line: the column
      const int ys = y + oy[line_y];
      const float u0 = __bfloat162float(wy[2 * line_y]);
      const float u1 = __bfloat162float(wy[2 * line_y + 1]);
      const float p0 = (ys >= 0 && ys < P) ? __bfloat162float(pn[((int64_t)ys * P + xs) * C + ch]) : 0.f;
      const float p1 = (ys + 1 >= 0 && ys + 1 < P) ? __bfloat162float(pn[((int64_t)(ys + 1) * P + xs) * C + ch]) : 0.f;
      v = rbf(rbf(u0 * p0) + rbf(u1 * p1));
    }
    tv[a] = v;
  }
  out[t] = __float2bfloat16_rn(rbf(w0 * tv[0]) + rbf(w1 * tv[1]));
}

}  // namespace

extern "C" int shear_rotate_launch(const void* patches, const void* oy, const void* wy,
                                   const void* ox, const void* wx, int N, int P, int E,
                                   int C, void* out, void* stream) {
  const int64_t total = (int64_t)N * E * E * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  shear_rotate<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)patches, (const int*)oy, (const __nv_bfloat16*)wy,
      (const int*)ox, (const __nv_bfloat16*)wx, N, P, E, C, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
