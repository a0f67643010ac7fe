// Kernel D: per lane, gather one channel-major block row and take the
// nearest Cramer t over its triangle lanes.
//
// Replaces the Pallas kernel of tools/pallas_gather_bench.py
// (pallas_gather_test, pallas_call at :98, body _pl_kernel at :77): a
// scalar-prefetch grid of W programs, program i DMAs row idx[i] of an
// (NB, 9, TL) table (9 triangle-component channels x TL triangle lanes)
// and runs the tool's cramer_min on it (:36-58): its own det3 expansion
// u0*(v1*w2 - v2*w1) - v0*(u1*w2 - u2*w1) + w0*(u1*v2 - u2*v1), inv = 1/A,
// t = tn*inv, beta = bn*inv, gamma = gn*inv, accept beta > 0, gamma > 0,
// beta + gamma < 1, t > 0, and +inf on a lane with no hit.  It measures the
// row gather that the packed march makes.
//
// Layout: one warp per lane.  Thread j of the warp takes triangle lanes j,
// j+32, j+64, ... so that each channel load is one coalesced 128-byte
// read per 32 lanes; a warp-shuffle min folds the 32 partial minima.  The
// minimum of non-NaN floats (accepted t are finite and > 0) does not
// depend on the order, so the result is bitwise the plain version's; the
// build's -fmad=false keeps every product and sum rounding alone.
//
// Bound on the H100: device-memory bytes.  Each lane reads one 9*TL*4 =
// 4,608-byte row (the table's distinct rows count once for the bound) and
// its 28 bytes of ray and index, and writes 4 bytes; the arithmetic is
// about 63 FP32 operations per triangle lane.  The design reads each row
// with full 128-byte transactions and keeps no intermediate in memory;
// with W = 8192 lanes it fills 8,192 warps, about 62 per SM (32 registers,
// 97% achieved occupancy).  The table stays in the 50 MB L2 across calls,
// so what bounds a call in practice is the L2-to-SM traffic: every lane
// reads its whole row (37.7 MB at W = 8192, 3.6 lanes a row), about 5.6
// TB/s at 6.7 us.  Four redesigns were timed against this one in turns on
// the card and lost (PERF.md section 6): 128-bit loads of four triangle
// lanes a thread (56 registers, half the occupancy, the same bytes); a
// counting pass into per-row buckets and a block a row fed by one bulk
// copy (each row read once, but the pass and each block's load-then-test
// chain cost more than the bytes saved), as two launches or one
// cooperative kernel; and a block a range of rows that scans idx itself.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float det3(const float u[3], const float v[3],
                                      const float w[3]) {
  return u[0] * (v[1] * w[2] - v[2] * w[1]) - v[0] * (u[1] * w[2] - u[2] * w[1]) +
         w[0] * (u[1] * v[2] - u[2] * v[1]);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gather_row_test_kernel(const float* __restrict__ blocks, const float* __restrict__ orig,
                       const float* __restrict__ dirn, const int* __restrict__ idx,
                       int w, int tl, float* __restrict__ out) {
  const int lane = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int j0 = threadIdx.x % 32;
  if (lane >= w) return;
  const float* row = blocks + (size_t)idx[lane] * 9 * tl;
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = orig[3 * lane + k];
    d[k] = dirn[3 * lane + k];
  }
  float best = INFINITY;
  for (int j = j0; j < tl; j += 32) {
    float e1[3], e2[3], s[3];
    for (int k = 0; k < 3; ++k) {
      const float a = row[k * tl + j];
      const float b = row[(3 + k) * tl + j];
      const float c = row[(6 + k) * tl + j];
      e1[k] = a - b;
      e2[k] = a - c;
      s[k] = a - o[k];
    }
    const float A = det3(e1, e2, d);
    const float tn = det3(e1, e2, s);
    const float bn = det3(s, e2, d);
    const float gn = det3(e1, s, d);
    const float inv = 1.0f / A;
    const float t = tn * inv;
    const float beta = bn * inv;
    const float gamma = gn * inv;
    const bool ok = beta > 0.0f && gamma > 0.0f && beta + gamma < 1.0f && t > 0.0f;
    if (ok && t < best) best = t;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, best, off);
    best = other < best ? other : best;
  }
  if (j0 == 0) out[lane] = best;
}

}  // namespace

// blocks (nb, 9, tl) f32 channel-major rows, orig/dirn (w, 3) f32, idx (w,)
// i32 row indices in [0, nb); writes out (w,) f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int gather_row_test_launch(const float* blocks, const float* orig,
                                      const float* dirn, const int* idx, int w, int tl,
                                      float* out, void* stream) {
  if (w > 0) {
    const int grid = (w + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gather_row_test_kernel<<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        blocks, orig, dirn, idx, w, tl, out);
  }
  return (int)cudaGetLastError();
}
