// Windowed bilinear lookup on contiguous pyramid levels, and its gradient,
// for Hopper (sm_90a): the kernels of the training path.
//
// A level is (Q, h2, w2), query-major: query q owns the contiguous plane
// vol[q].  For every query the lookup samples a (2r+1)^2 = 49-tap window
// (r = 3) of its plane at the float position coords[q] = [x, y]: bilinear,
// zero contribution from outside the plane, channels x-offset major
// (out[q, ox * 7 + oy]).
//
// Three kernels:
//   lookup_level_fwd     replaces the TPU kernel droid_slam_tpu/ops/
//                        corr_pallas.py: lookup_level_pallas (body
//                        _lookup_kernel): 8x8 window, four-corner combine.
//   lookup_level_v2_fwd  replaces lookup_level_pallas_v2 (body
//                        _lookup_kernel_v2): window rows blended along x,
//                        then neighbouring rows blended along y.
//                        Both forwards serve a whole pyramid of up to four
//                        levels in one launch: coords are at level-0
//                        resolution and level l lands at
//                        out[q, 49 l + ox * 7 + oy].
//   lookup_level_bwd     the gradient of either forward with respect to the
//                        volume (the TPU package differentiates its jnp
//                        lookup; there is no TPU kernel for it); one level.
//
// The TPU kernels zero-pad every plane to (8, 128) tiles and bring the
// window to the origin with dynamic rotates, because a TPU cannot slice a
// lane dimension at a traced offset.  None of that is carried over: these
// kernels check bounds per element and read the window where it lies.  A
// window row is 8 adjacent floats (one 32-byte sector when aligned).
//
// Each kernel keeps the operation order of its plain PyTorch version
// (ops/corr.py: lookup_pyramid_level_reference,
// lookup_pyramid_level_v2_reference, lookup_level_backward_reference) and
// uses the _rn intrinsics so that nvcc contracts nothing into FMAs.
//
// Schedules.
//   fwd:  that of lookup_pyramid.cuh with the four-corner combine: eight
//         lanes a query (a lane owns a window column, so a warp-wide load
//         reads four 32-byte row segments), a level's eight loads in
//         flight together, neighbouring columns by shuffle,
//         a run's taps written as one contiguous stretch of 16-byte stores,
//         a grid sized to the card striding over the runs.  Its first
//         version was one warp per query and level: 122,880 one-shot warps
//         a level at the training shapes, each two dependent round trips to
//         device memory long (coordinates, then two 4-byte loads a lane)
//         with ~460 bytes in flight, so every level cost the same whatever
//         its planes' size, and a pyramid was four launches, four
//         coordinate divides and a concatenation that moved more bytes than
//         the kernels.  At the training shapes a pyramid takes 0.125 ms
//         where the first version's four launches took 0.153 (NVIDIA H100
//         80GB HBM3, 700.00 W; tools/torch_bench_lookup.py).
//   v2:   the same schedule with the separable combine.  Its first
//         version was one launch per level with a lane owning a window
//         ROW: each of a warp's eight loads touched 32 plane rows, one
//         sector each for 4 useful bytes a lane, taps left by scalar
//         stores, and a pyramid was four launches, four coordinate
//         divides and a concatenation (0.167 ms per pyramid at the
//         training shapes, NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).
//   bwd:  one warp per query.  The 49 tap gradients are staged in shared
//         memory with a zero border; window element (a, b) gathers the (at
//         most four) tap gradients it fed, with their bilinear weights.  A
//         query owns its plane, so there are no atomics and the result is
//         deterministic.  The caller zero-fills the gradient; the kernel
//         writes only in-bounds window elements.
//
// Bound on the H100 (3.35 TB/s): bytes.  Forward, per query and level: at
// most 64 window elements (256 B of f32) and 196 B of taps, plus 8 B of
// coordinates per query; a four-level pyramid of the training shapes (Q =
// 40 * 48 * 64) is about 192 MB, 57 us.  Backward: the dense gradient
// itself, Q * h2 * w2 * 4 B, written once (1.51 GB, 0.45 ms at level 0):
// the zero fill dominates, the kernel's own traffic is that of a forward.
// Offsets are 64-bit: a level-0 volume at batch 4 passes 2^31 bytes.

#include "lookup_pyramid.cuh"

namespace {

using namespace lookup;

// integer window origin and bilinear weights of one query
struct Query {
  int x0, y0;
  float dx, dy, omx, omy;
};

__device__ __forceinline__ Query read_query(const float* __restrict__ coords,
                                            int64_t q) {
  Query s;
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  const float x0f = floorf(cx);
  const float y0f = floorf(cy);
  s.dx = __fsub_rn(cx, x0f);
  s.dy = __fsub_rn(cy, y0f);
  s.omx = __fsub_rn(1.0f, s.dx);
  s.omy = __fsub_rn(1.0f, s.dy);
  // clamp before the int cast (far-out windows match nothing anyway)
  s.x0 = (int)fminf(fmaxf(x0f, -2e4f), 2e4f);
  s.y0 = (int)fminf(fmaxf(y0f, -2e4f), 2e4f);
  return s;
}

template <typename T, bool kSeparable>
__global__ void __launch_bounds__(kThreads)
lookup_level_fwd_kernel(const Pyramid pyr, const float* __restrict__ coords,
                        float* __restrict__ out, int64_t Q) {
  __shared__ __align__(16) float stage[kWarps][kRun * kTaps * kMaxLevels];
  const int warp = threadIdx.x >> 5;
  // one edge of Q queries: plane q belongs to query q
  lookup_pyramid_warp<T, kSeparable>(
      pyr, coords, out, Q, 1, 1, stage[warp],
      (int64_t)blockIdx.x * kWarps + warp, (int64_t)gridDim.x * kWarps);
}

template <typename T, bool kSeparable>
int launch_pyramid(const Pyramid& pyr, const float* coords, float* out,
                   int64_t Q, cudaStream_t s) {
  const unsigned blocks =
      pyramid_grid(lookup_level_fwd_kernel<T, kSeparable>, Q);
  lookup_level_fwd_kernel<T, kSeparable><<<blocks, kThreads, 0, s>>>(
      pyr, coords, out, Q);
  return (int)cudaGetLastError();
}

template <bool kSeparable>
int launch_pyramid(const void* const* vols, const int* h2, const int* w2,
                   int levels, int dtype, const float* coords, float* out,
                   int64_t Q, void* stream) {
  Pyramid pyr;
  if (!make_pyramid(&pyr, vols, h2, w2, levels)) {
    return (int)cudaErrorInvalidValue;
  }
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_pyramid<float, kSeparable>(pyr, coords, out, Q, s);
  }
  if (dtype == 1) {
    return launch_pyramid<__nv_bfloat16, kSeparable>(pyr, coords, out, Q, s);
  }
  return (int)cudaErrorInvalidValue;
}

__global__ void __launch_bounds__(kThreads)
lookup_level_bwd_kernel(const float* __restrict__ grad_taps,
                        const float* __restrict__ coords,
                        float* __restrict__ grad_vol, int64_t Q, int h2,
                        int w2) {
  // g[oy + 1][ox + 1] = gradient of tap (ox, oy); a zero border all round
  __shared__ float g[kWarps][kWin + 1][kWin + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kWarps + warp;
  if (q >= Q) return;   // the whole warp leaves; only warp-level syncs below
  float* gw = &g[warp][0][0];
  for (int i = lane; i < (kWin + 1) * (kWin + 1); i += 32) gw[i] = 0.0f;
  __syncwarp();
  const float* gt = grad_taps + q * kTaps;
  for (int t = lane; t < kTaps; t += 32) {
    const int ox = t / kDiam;
    const int oy = t - ox * kDiam;
    g[warp][oy + 1][ox + 1] = gt[t];
  }
  __syncwarp();

  const Query s = read_query(coords, q);
  const float w00 = __fmul_rn(s.omx, s.omy);
  const float w10 = __fmul_rn(s.dx, s.omy);
  const float w01 = __fmul_rn(s.omx, s.dy);
  const float w11 = __fmul_rn(s.dx, s.dy);
  const int row = lane >> 2;
  const int col = (lane & 3) * 2;
  const int y = s.y0 - kRadius + row;
  if (y < 0 || y >= h2) return;
  float* plane = grad_vol + q * ((int64_t)h2 * w2) + (int64_t)y * w2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = col + j;
    const int x = s.x0 - kRadius + b;
    if (x < 0 || x >= w2) continue;
    float v = __fmul_rn(w00, g[warp][row + 1][b + 1]);
    v = __fadd_rn(v, __fmul_rn(w10, g[warp][row + 1][b]));
    v = __fadd_rn(v, __fmul_rn(w01, g[warp][row][b + 1]));
    v = __fadd_rn(v, __fmul_rn(w11, g[warp][row][b]));
    plane[x] = v;
  }
}

inline unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each function launches on `stream` and
// returns cudaGetLastError() (0 on success).

// vols: `levels` (1..4) device pointers, level l holding Q contiguous
// (h2[l], w2[l]) planes of one dtype.  coords (Q, 2) at level-0 resolution
// and out (Q, 49 levels) are contiguous float32, out 16-byte aligned.
// lookup_level_fwd combines the four corners, lookup_level_v2_fwd blends
// along x, then along y.
extern "C" int lookup_level_fwd(const void* const* vols, const int* h2,
                                const int* w2, int levels, int dtype,
                                const float* coords, float* out, int64_t Q,
                                void* stream) {
  return launch_pyramid<false>(vols, h2, w2, levels, dtype, coords, out, Q,
                               stream);
}

extern "C" int lookup_level_v2_fwd(const void* const* vols, const int* h2,
                                   const int* w2, int levels, int dtype,
                                   const float* coords, float* out,
                                   int64_t Q, void* stream) {
  return launch_pyramid<true>(vols, h2, w2, levels, dtype, coords, out, Q,
                              stream);
}

// grad_taps (Q, 49), coords (Q, 2) and grad_vol (Q, h2, w2) are contiguous
// float32; grad_vol must arrive zeroed.
extern "C" int lookup_level_bwd(const float* grad_taps, const float* coords,
                                float* grad_vol, int64_t Q, int h2, int w2,
                                void* stream) {
  if (Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lookup_level_bwd_kernel<<<blocks_for(Q), kThreads, 0, s>>>(
      grad_taps, coords, grad_vol, Q, h2, w2);
  return (int)cudaGetLastError();
}
