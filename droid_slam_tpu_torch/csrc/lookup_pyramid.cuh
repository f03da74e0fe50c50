// One-launch pyramid lookup for Hopper (sm_90a): the schedule shared by the
// serving kernel (corr_lookup.cu) and the two training forwards
// (corr_lookup_level.cu: lookup_level_fwd, lookup_level_v2_fwd).
//
// Function.  A pyramid is up to four levels of query-major planes: level l
// holds one contiguous (h2_l, w2_l) plane per query.  For every query and
// level the lookup samples a (2r+1)^2 = 49-tap window (r = 3) of the query's
// own plane at coords * 2^-l: bilinear, zero contribution from outside the
// plane, channels x-offset major; level l lands at channel 49 l of the
// query's output row (49 L floats).  A query's plane is its own: nothing is
// shared between queries, so the least traffic is the window itself and the
// design is about memory sectors and latency.
//
// Schedule.  Eight lanes serve a query, four queries a warp, and a warp owns
// runs of four consecutive queries (a grid sized to the card strides over the
// runs; warps never wait for each other).
//   * Lane c of a query owns window column c.  Its eight loads per level
//     (one per window row) sit next to the loads of the query's other seven
//     lanes, so a warp-wide load touches four row segments of 8 elements
//     (16 bytes of bf16, 32 of f32: one or two 32-byte sectors each) instead
//     of 32 unrelated sectors.
//   * A lane issues a level's eight loads together and the coordinates are
//     read once a run and scaled in the kernel (2^-l is exact).  The bytes
//     in flight come from occupancy: at 48 registers forty warps share an
//     SM.  Holding the loads of all four levels in registers instead (80-96
//     registers, 16-24 warps an SM) measured slower on the H100.
//   * Column c + 1 comes from the neighbouring lane by __shfl_down_sync, so
//     the window never goes through shared memory; seven of eight lanes then
//     compute the seven taps of their column.
//   * Taps leave through shared memory: a run's 4 * 49 L floats are one
//     contiguous, 16-byte aligned stretch of the output, written with
//     16-byte stores.
// With this schedule the kernel runs at the rate device memory delivers the
// sectors the windows touch: a window row is 16-32 bytes at a pitch of one
// plane row, so the sectors fetched are 2-3 times the window's bytes at the
// large levels.
//
// Arithmetic.  Two combine orders, each that of its plain PyTorch version in
// ops/corr.py, with the _rn intrinsics so that nvcc contracts nothing into
// FMAs (bit-identical results):
//   separable  rows blended along x, then neighbouring rows along y
//              (lookup_pyramid_flat_reference, and
//              lookup_pyramid_level_v2_reference of lookup_level_v2_fwd);
//   corners    the four bilinear corner weights times the four window
//              elements, summed in order (lookup_pyramid_level_reference
//              of lookup_level_fwd).
//
// Offsets of planes are 64-bit: a level-0 training volume at batch 4 passes
// 2^31 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lookup {

constexpr int kRadius = 3;
constexpr int kDiam = 2 * kRadius + 1;   // 7 taps per axis
constexpr int kWin = kDiam + 1;          // 8 integer rows/cols
constexpr int kTaps = kDiam * kDiam;     // 49
constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;                // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRun = 32 / kWin;          // queries a warp serves at a time
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The levels of one pyramid: base pointers of Q contiguous planes each.
struct Pyramid {
  const void* vol[kMaxLevels];
  int h2[kMaxLevels];
  int w2[kMaxLevels];
  int levels;
};

// Query g of `n_queries` reads plane (g / q_per_edge) * planes_per_edge +
// g % q_per_edge of every level (an edge may hold more planes than it has
// queries); coords (n_queries, 2) and out (n_queries, 49 levels) are
// contiguous float32, out 16-byte aligned.  `stage` is the calling warp's
// kRun * kTaps * kMaxLevels floats of shared memory, 16-byte aligned.
template <typename T, bool kSeparable>
__device__ __forceinline__ void lookup_pyramid_warp(
    const Pyramid& pyr, const float* __restrict__ coords,
    float* __restrict__ out, int64_t n_queries, int q_per_edge,
    int planes_per_edge, float* __restrict__ stage, int64_t first_run,
    int64_t run_stride) {
  const int lane = threadIdx.x & 31;
  const int sub = lane / kWin;   // query of the run
  const int col = lane % kWin;   // window column of the query
  const int L = pyr.levels;
  const int row_floats = kTaps * L;
  const int64_t n_runs = (n_queries + kRun - 1) / kRun;

  for (int64_t run = first_run; run < n_runs; run += run_stride) {
    const int64_t g0 = run * kRun;
    const int64_t g = g0 + sub;
    const bool live = g < n_queries;
    float cx = 0.0f, cy = 0.0f;
    int64_t plane = 0;
    if (live) {
      cx = coords[2 * g];
      cy = coords[2 * g + 1];
      plane = g;
      if (planes_per_edge != q_per_edge) {
        const int64_t e = g / q_per_edge;
        plane = e * planes_per_edge + (g - e * q_per_edge);
      }
    }

#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= L) break;
      const float scale = 1.0f / (float)(1 << l);
      const float px = __fmul_rn(cx, scale);
      const float py = __fmul_rn(cy, scale);
      const float x0f = floorf(px);
      const float y0f = floorf(py);
      const float dx = __fsub_rn(px, x0f);
      const float dy = __fsub_rn(py, y0f);
      // clamp before the int cast (far-out windows match nothing anyway)
      const int x = (int)fminf(fmaxf(x0f, -2e4f), 2e4f) - kRadius + col;
      const int y0 = (int)fminf(fmaxf(y0f, -2e4f), 2e4f) - kRadius;
      const int h2 = pyr.h2[l];
      const int w2 = pyr.w2[l];
      const bool col_ok = live && x >= 0 && x < w2;
      const T* p = static_cast<const T*>(pyr.vol[l]) +
                   plane * ((int64_t)h2 * w2) + x;
      // the lane's window column: eight loads in flight
      float v[kWin];
#pragma unroll
      for (int r = 0; r < kWin; ++r) {
        const int y = y0 + r;
        v[r] = (col_ok && y >= 0 && y < h2) ? load_f32(p + y * w2) : 0.0f;
      }
      float right[kWin];   // column col + 1 (lane 7 of a query: unused)
#pragma unroll
      for (int r = 0; r < kWin; ++r) {
        right[r] = __shfl_down_sync(kFullMask, v[r], 1, kWin);
      }
      const float omx = __fsub_rn(1.0f, dx);
      const float omy = __fsub_rn(1.0f, dy);
      float tap[kDiam];
      if (kSeparable) {
        float tx[kWin];
#pragma unroll
        for (int r = 0; r < kWin; ++r) {
          tx[r] = __fadd_rn(__fmul_rn(omx, v[r]), __fmul_rn(dx, right[r]));
        }
#pragma unroll
        for (int oy = 0; oy < kDiam; ++oy) {
          tap[oy] = __fadd_rn(__fmul_rn(omy, tx[oy]),
                              __fmul_rn(dy, tx[oy + 1]));
        }
      } else {
        const float w00 = __fmul_rn(omx, omy);
        const float w10 = __fmul_rn(dx, omy);
        const float w01 = __fmul_rn(omx, dy);
        const float w11 = __fmul_rn(dx, dy);
#pragma unroll
        for (int oy = 0; oy < kDiam; ++oy) {
          float t = __fmul_rn(w00, v[oy]);
          t = __fadd_rn(t, __fmul_rn(w10, right[oy]));
          t = __fadd_rn(t, __fmul_rn(w01, v[oy + 1]));
          tap[oy] = __fadd_rn(t, __fmul_rn(w11, right[oy + 1]));
        }
      }
      if (col < kDiam) {
        float* s = stage + sub * row_floats + l * kTaps + col * kDiam;
#pragma unroll
        for (int oy = 0; oy < kDiam; ++oy) s[oy] = tap[oy];
      }
    }
    __syncwarp();

    // the run's taps: one contiguous stretch, 16-byte aligned (kRun rows
    // of 49 L floats are a multiple of 16 bytes); only the last run of
    // the launch can be short and leave a few floats for scalar stores
    const int64_t left = n_queries - g0;
    const int n = (int)(left < kRun ? left : kRun) * row_floats;
    float* o = out + g0 * row_floats;
    const float4* s4 = reinterpret_cast<const float4*>(stage);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = lane; i < n / 4; i += 32) o4[i] = s4[i];
    for (int i = (n & ~3) + lane; i < n; i += 32) o[i] = stage[i];
    __syncwarp();
  }
}

// Fills `pyr` from the arrays a C caller hands over; false when the number
// of levels is out of range.
inline bool make_pyramid(Pyramid* pyr, const void* const* vols, const int* h2,
                         const int* w2, int levels) {
  if (levels < 1 || levels > kMaxLevels) return false;
  *pyr = Pyramid{};
  pyr->levels = levels;
  for (int l = 0; l < levels; ++l) {
    pyr->vol[l] = vols[l];
    pyr->h2[l] = h2[l];
    pyr->w2[l] = w2[l];
  }
  return true;
}

// Blocks of a grid-stride launch of `kernel`: enough to fill the card
// once, no more than the runs need.
template <typename Kernel>
inline unsigned pyramid_grid(Kernel kernel, int64_t n_queries) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t n_runs = (n_queries + kRun - 1) / kRun;
  const int64_t need = (n_runs + kWarps - 1) / kWarps;
  const int64_t fill = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(need < fill ? need : fill);
}

}  // namespace lookup
