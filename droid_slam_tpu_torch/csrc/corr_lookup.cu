// Windowed bilinear correlation lookup of the serving path for Hopper
// (sm_90a), one launch per pyramid.
//
// Replaces the TPU kernel droid_slam_tpu/ops/corr_pallas.py:
// lookup_flat_pallas_v3 (kernel body _lookup_kernel_v3).  For every query
// pixel q of edge e and every pyramid level l it samples a (2r+1)^2 = 49-tap
// window (r = 3) of the correlation plane vol_l[e, q] at the float position
// coords[e, q] * 2^-l = [x, y]: bilinear, zero contribution for every tap row
// or column outside the plane, channels x-offset major
// (out[e, q, 49 l + ox * 7 + oy]).
//
// Arithmetic is the TPU kernel's: the volume is widened to f32, x0 =
// floor(x), dx = x - x0 (same for y), the 8x8 integer window is blended
// along x first and then along y.  Products and sums use the _rn
// intrinsics so nvcc does not contract them into FMAs: the result is
// bit-identical to the plain PyTorch version (ops/corr.py:
// lookup_pyramid_flat_reference), which runs the same elementwise ops.
//
// Bound on the H100 (3.35 TB/s): bytes.  Per query and level the least
// traffic is the 64 window elements (bf16: 128 B) and 49 f32 taps (196 B),
// plus 8 B of coordinates per query.  A four-level pyramid of the 240x320
// main path (64 edges of 1200 queries) is ~86 MB, ~26 us.
//
// What held the first version back.  The TPU kernel puts queries on lanes,
// so its volume is query-last (E, h2, w2, Q); the first version kept that
// layout with one thread per (edge, query).  On this card every one of a
// thread's 64 window loads then was its own 32-byte sector for 2 useful
// bytes, every one of its 49 stores touched 32 sectors a warp, and a pyramid
// cost four launches, four coordinate divides and a concatenation.
//
// This design.  The volume is query-major (E, Q, h2, w2), as
// runtime/fused.py: edge_volumes and the on-the-fly path now emit it, so a
// window row is 16 adjacent bytes.  The schedule is that of
// lookup_pyramid.cuh: eight lanes a query with coalesced row segments, the
// loads of all levels in flight at once, neighbouring columns by shuffle,
// taps written as contiguous 16-byte stores through shared memory, the four
// levels and their coordinate scaling in one launch.  At the shapes above a
// pyramid takes 0.062 ms where the first version's four launches took 0.38
// (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_bench_lookup.py).

#include "lookup_pyramid.cuh"

namespace {

using namespace lookup;

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(const Pyramid pyr, const float* __restrict__ coords,
                   float* __restrict__ out, int64_t n_queries,
                   int q_per_edge, int planes_per_edge) {
  __shared__ __align__(16) float stage[kWarps][kRun * kTaps * kMaxLevels];
  const int warp = threadIdx.x >> 5;
  lookup_pyramid_warp<T, /*kSeparable=*/true>(
      pyr, coords, out, n_queries, q_per_edge, planes_per_edge, stage[warp],
      (int64_t)blockIdx.x * kWarps + warp, (int64_t)gridDim.x * kWarps);
}

template <typename T>
int launch(const Pyramid& pyr, const float* coords, float* out,
           int64_t n_queries, int q_per_edge, int planes_per_edge,
           cudaStream_t s) {
  const unsigned blocks = pyramid_grid(corr_lookup_kernel<T>, n_queries);
  corr_lookup_kernel<T><<<blocks, kThreads, 0, s>>>(
      pyr, coords, out, n_queries, q_per_edge, planes_per_edge);
  return (int)cudaGetLastError();
}

}  // namespace

// vols: `levels` (1..4) device pointers, level l holding E * planes_per_edge
// contiguous (h2[l], w2[l]) planes; dtype: 0 = float32, 1 = bfloat16 (all
// levels alike).  coords (E, q_per_edge, 2) at level-0 resolution and out
// (E, q_per_edge, 49 levels) are contiguous float32, out 16-byte aligned;
// n_queries = E * q_per_edge, q_per_edge <= planes_per_edge.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int corr_lookup(const void* const* vols, const int* h2,
                           const int* w2, int levels, int dtype,
                           const float* coords, float* out, int64_t n_queries,
                           int q_per_edge, int planes_per_edge,
                           void* stream) {
  Pyramid pyr;
  if (!make_pyramid(&pyr, vols, h2, w2, levels) ||
      q_per_edge > planes_per_edge) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_queries == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(pyr, coords, out, n_queries, q_per_edge,
                         planes_per_edge, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(pyr, coords, out, n_queries, q_per_edge,
                                 planes_per_edge, s);
  }
  return (int)cudaErrorInvalidValue;
}
