// Kernel A: all-pairs nearest ray/triangle hit.
//
// Replaces the Pallas TPU kernel ray_tracer_tpu/ops/pallas_intersect.py:_kernel
// (launched by _run, wrapped by intersect_brute_pallas) and computes what it
// computes: for each ray the lowest-index triangle with the smallest t among
// those with beta > 0, gamma > 0, beta + gamma < 1 and t > t_lower, with
// t = tn * (1/A) as the Pallas kernel forms it (cramer.cuh, kReciprocal).
//
// Design: one thread owns one ray; a CTA of 256 rays stages the triangle
// soup in chunks of 512 triangles in shared memory (v0 and the two edge
// columns, 9 floats = 18 KB a chunk, loaded coalesced from the (9, F) SoA
// table) and every thread scans the chunk in ascending index, replacing its
// record on a strict `<`.  That is the Pallas kernel's lowest-index
// tie-break, since an accepted t always exceeds t_lower and is never NaN.
//
// Bound on the H100: operations.  Each (ray, triangle) pair costs 51 FP32
// operations (four 3x3 determinants with their common products shared, one
// reciprocal, three products and the tests; OPS_PER_PAIR_A in chip_smoke.py)
// against 4 bytes of shared-memory traffic per operand, and the soup is read
// from device memory once per CTA.  This first version is simple and
// correct, not tuned: the IEEE division per pair, -fmad=false (which halves
// the FMA issue rate but keeps the bytes equal to the plain version) and a
// single-buffered stage are left for later work, as are occupancy tuning and
// culling rays against chunk bounds.  wgmma does not apply: the contraction
// depth is 3.
#include <cuda_runtime.h>

#include "cramer.cuh"

namespace {

constexpr int kTileR = 256;  // rays per CTA, one per thread
constexpr int kTileT = 512;  // triangles per staged chunk

__global__ void __launch_bounds__(kTileR)
brute_intersect_kernel(const float* __restrict__ orig,
                       const float* __restrict__ dirn,
                       const float* __restrict__ tri9,  // (9, n_tris)
                       int n_rays, int n_tris, float t_lower,
                       float* __restrict__ t_out, int* __restrict__ id_out) {
  // rows: v0 (0-2), e1 = v0 - v1 (3-5), e2 = v0 - v2 (6-8)
  __shared__ float sh[9][kTileT];
  const int r = blockIdx.x * kTileR + threadIdx.x;
  const bool live = r < n_rays;
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = live ? orig[3 * r + k] : 0.0f;
    d[k] = live ? dirn[3 * r + k] : 1.0f;
  }
  float best_t = INFINITY;
  int best_id = -1;
  for (int base = 0; base < n_tris; base += kTileT) {
    const int cnt = min(kTileT, n_tris - base);
    __syncthreads();  // the previous chunk is consumed
    for (int j = threadIdx.x; j < cnt; j += kTileR) {
      float v[9];
      for (int k = 0; k < 9; ++k) v[k] = tri9[(size_t)k * n_tris + base + j];
      for (int k = 0; k < 3; ++k) {
        sh[k][j] = v[k];
        sh[3 + k][j] = v[k] - v[3 + k];
        sh[6 + k][j] = v[k] - v[6 + k];
      }
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float e1[3] = {sh[3][j], sh[4][j], sh[5][j]};
      const float e2[3] = {sh[6][j], sh[7][j], sh[8][j]};
      const float s[3] = {sh[0][j] - o[0], sh[1][j] - o[1], sh[2][j] - o[2]};
      float t, beta, gamma;
      cramer_columns<float, true>(e1, e2, s, d, t, beta, gamma);
      if (barycentric_pass(beta, gamma) && t > t_lower && t < best_t) {
        best_t = t;
        best_id = base + j;
      }
    }
  }
  if (live) {
    t_out[r] = best_t;
    id_out[r] = best_id;
  }
}

}  // namespace

// orig, dirn: (n_rays, 3) f32; tri9: (9, n_tris) f32 rows v0x..v2z.
// Writes t (n_rays,) f32 (+inf where no hit) and tri_id (n_rays,) i32
// (-1 where no hit).  Returns cudaGetLastError() after the launch.
extern "C" int brute_intersect_launch(const float* orig, const float* dirn,
                                      const float* tri9, int n_rays,
                                      int n_tris, float t_lower, float* t_out,
                                      int* id_out, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kTileR - 1) / kTileR;
    brute_intersect_kernel<<<blocks, kTileR, 0, (cudaStream_t)stream>>>(
        orig, dirn, tri9, n_rays, n_tris, t_lower, t_out, id_out);
  }
  return (int)cudaGetLastError();
}
