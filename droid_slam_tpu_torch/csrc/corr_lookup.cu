// Windowed bilinear correlation lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel droid_slam_tpu/ops/corr_pallas.py:
// lookup_flat_pallas_v3 (kernel body _lookup_kernel_v3).  For every query
// pixel q of edge e it samples a (2r+1)^2 = 49-tap window (r = 3) of the
// correlation plane vol[e, :, :, q] at the float position coords[e, q] =
// [x, y]: bilinear, zero contribution for every tap row or column outside
// the plane, channels x-offset major (out[..., ox * 7 + oy]).
//
// Arithmetic is the TPU kernel's: the volume is widened to f32, x0 =
// floor(x), dx = x - x0 (same for y), the 8x8 integer window is blended
// along x first and then along y.  Products and sums use the _rn
// intrinsics so nvcc does not contract them into FMAs: the result is
// bit-identical to the plain PyTorch version (ops/corr.py:
// lookup_flat_reference), which runs the same elementwise ops.
//
// Design.  The TPU kernel puts 128 queries on lanes and selects rows and
// columns by masked reductions, because a TPU has no per-lane gather.
// Hopper gathers, so this is one thread per (edge, query): the thread
// reads its 8x8 window with bounds checks and writes 49 floats.  With the
// query axis innermost (the layout the frontend's volume builder emits),
// neighbouring threads read neighbouring addresses only where they sample
// the same (y, x); on a flow field neighbouring queries sit one column
// apart, so each tap is its own memory sector.  The volume's strides are
// arguments, so the same launch serves query-major (Q, h2, w2) planes too.
//
// Bound on the H100 (3.35 TB/s): bytes.  Per query the least traffic is
// the 64 window taps (bf16: 128 B), 49 f32 outputs (196 B) and the
// coordinates (8 B).  At level 0 of the 240x320 main path (E = 64, Q =
// 1200) that is ~25.5 MB, ~7.6 us.  Not tuned yet: no shared-memory
// staging, no TMA, one pyramid level per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kDiam = 2 * kRadius + 1;   // 7 taps per axis
constexpr int kWin = kDiam + 1;          // 8 integer rows/cols

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T>
__global__ void corr_lookup_kernel(const T* __restrict__ vol,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out, int E, int Q,
                                   int h2, int w2, int64_t se, int64_t sy,
                                   int64_t sx, int64_t sq) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)E * Q) return;
  const int e = (int)(tid / Q);
  const int q = (int)(tid - (int64_t)e * Q);

  const float cx = coords[2 * tid];
  const float cy = coords[2 * tid + 1];
  const float x0f = floorf(cx);
  const float y0f = floorf(cy);
  const float dx = __fsub_rn(cx, x0f);
  const float dy = __fsub_rn(cy, y0f);
  const float omx = __fsub_rn(1.0f, dx);
  const float omy = __fsub_rn(1.0f, dy);
  // clamp before the int cast (far-out windows match nothing anyway)
  const int x0 = (int)fminf(fmaxf(x0f, -2e4f), 2e4f);
  const int y0 = (int)fminf(fmaxf(y0f, -2e4f), 2e4f);

  const T* base = vol + (int64_t)e * se + (int64_t)q * sq;
  float* o = out + tid * (kDiam * kDiam);

  float prev[kDiam];
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const int y = y0 - kRadius + k;
    const bool row_ok = (y >= 0) && (y < h2);
    float r[kWin];
#pragma unroll
    for (int c = 0; c < kWin; ++c) {
      const int x = x0 - kRadius + c;
      r[c] = (row_ok && x >= 0 && x < w2)
                 ? load_f32(base + (int64_t)y * sy + (int64_t)x * sx)
                 : 0.0f;
    }
    float cur[kDiam];
#pragma unroll
    for (int c = 0; c < kDiam; ++c) {
      cur[c] = __fadd_rn(__fmul_rn(omx, r[c]), __fmul_rn(dx, r[c + 1]));
    }
    if (k > 0) {
#pragma unroll
      for (int ox = 0; ox < kDiam; ++ox) {
        o[ox * kDiam + (k - 1)] =
            __fadd_rn(__fmul_rn(omy, prev[ox]), __fmul_rn(dy, cur[ox]));
      }
    }
#pragma unroll
    for (int c = 0; c < kDiam; ++c) prev[c] = cur[c];
  }
}

}  // namespace

// dtype: 0 = float32 volume, 1 = bfloat16 volume.  coords (E, Q, 2) and
// out (E, Q, 49) are contiguous float32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int corr_lookup(const void* vol, int dtype, const float* coords,
                           float* out, int E, int Q, int h2, int w2,
                           int64_t se, int64_t sy, int64_t sx, int64_t sq,
                           void* stream) {
  const int64_t n = (int64_t)E * Q;
  if (n == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    corr_lookup_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(vol), coords, out, E, Q, h2, w2, se, sy,
        sx, sq);
  } else if (dtype == 1) {
    corr_lookup_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), coords, out, E, Q, h2, w2,
        se, sy, sx, sq);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
