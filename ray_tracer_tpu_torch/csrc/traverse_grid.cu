// Kernel B: the CSR uniform-grid 3D-DDA, one thread per ray.
//
// Replaces the lock-step lax.while_loop of
// ray_tracer_tpu/ops/traverse.py:traverse_grid (with its entry setup
// _dda_setup), the port of the reference's per-ray grid walk
// (Serial/grid.h:167-231).  Each thread walks its own ray and gives the
// lock-step loop's answers exactly:
//   * per voxel, the candidate with the smallest t in the determinant type
//     (first index on ties) replaces the record only if it is below the
//     float32 running minimum, compared in the determinant type
//     (traverse.py:156-166);
//   * any_pass ORs every barycentric pass of every walked voxel, whatever
//     the gate (traverse.py:153-154);
//   * the step axis comes from the cmpToAxis LUT [2,1,2,1,2,2,0,0]
//     (traverse.py:49, 170-175) with IEEE comparisons, so +-inf and NaN
//     crossings of zero direction components step as they do there;
//   * the entry voxel truncates toward zero and clips, with NaN taken to 0
//     and out-of-range values saturated first, the XLA conversion the JAX
//     code relies on (traverse.py:70-71);
//   * a lane walks at most nx+ny+nz+2 steps and `steps` counts the voxels
//     it tested (traverse.py:110, 196).
// Determinants are templated on their type: float for the default,
// double for det_dtype="float64", the byte-exact path.  Everything else is
// float32, as in the JAX code.
//
// Bound on the H100: device-memory bytes, each counted once: the rays in
// (32 bytes each) and the five results out (14 bytes each), plus the CSR
// arrays and the vertex table (about 1 MB for the serial scene).  The walk
// re-reads cell_start, tri_ids and the vertices at every step and tested
// triangle, gathered without locality between neighbouring threads; those
// gathers are mostly served from L2 and set the kernel's time, far above
// that bound (chip_smoke.py reports both).  This
// first version is simple and correct, not tuned: no shared-memory staging
// of cell lists, no ray sorting for coherent gathers, no occupancy tuning;
// the double-precision determinants of the exact path run at the H100's
// FP64 rate.  wgmma does not apply: the contraction depth is 3.
#include <cuda_runtime.h>

#include "cramer.cuh"

namespace {

constexpr int kBlock = 128;
__constant__ int kCmpToAxis[8] = {2, 1, 2, 1, 2, 2, 0, 0};

// torch.minimum / jnp.minimum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// f32 -> cell index: NaN -> 0, saturate, truncate toward zero, clip.
__device__ __forceinline__ int to_cell(float f, int n) {
  if (f != f) f = 0.0f;
  if (f < -1.0f) f = -1.0f;
  if (f > (float)n) f = (float)n;
  const int p = (int)f;
  return p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
}

__device__ __forceinline__ int clip(int p, int n) {
  return p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
traverse_grid_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dirn,
                     const float* __restrict__ mint,
                     const float* __restrict__ maxt,
                     const float* __restrict__ gridf,  // lower, upper, width, inv_width
                     int nx, int ny, int nz,
                     const int* __restrict__ cell_start,
                     const int* __restrict__ tri_ids,
                     const float* __restrict__ tri9,  // (F, 9) v0 v1 v2
                     int n_rays, int has_gate, double t_gate, int early_exit,
                     int stop_on_first_hit, unsigned char* __restrict__ any_pass_out,
                     unsigned char* __restrict__ hit_out, float* __restrict__ t_out,
                     int* __restrict__ tri_out, int* __restrict__ steps_out,
                     int* __restrict__ tested_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int nv[3] = {nx, ny, nz};
  float lower[3], upper[3], width[3], inv_width[3], o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    lower[k] = gridf[k];
    upper[k] = gridf[3 + k];
    width[k] = gridf[6 + k];
    inv_width[k] = gridf[9 + k];
    o[k] = orig[3 * r + k];
    d[k] = dirn[3 * r + k];
  }
  const float mn = mint[r], mx = maxt[r];

  // ---- grid entry (_dda_setup, Serial/grid.h:170-203) ----------------
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    const float p = o[k] + d[k] * mn;
    inside = inside && (p >= lower[k]) && (p <= upper[k]);
  }
  float t0 = mn, t1 = mx;  // slab test, Serial/geometry.h:291-315
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / d[k];
    const float tn = (lower[k] - o[k]) * inv;
    const float tf = (upper[k] - o[k]) * inv;
    const float lo = nan_min(tn, tf), hi = nan_max(tn, tf);
    t0 = lo > t0 ? lo : t0;
    t1 = hi < t1 ? hi : t1;
  }
  const float ray_t = inside ? mn : t0;
  bool alive = inside || (t0 <= t1);

  int pos[3], step[3], out[3];
  float next_crossing[3], delta[3];
  for (int k = 0; k < 3; ++k) {
    const float gi = o[k] + d[k] * ray_t;
    pos[k] = to_cell((gi - lower[k]) * inv_width[k], nv[k]);
    const bool nonneg = d[k] >= 0.0f;
    step[k] = nonneg ? 1 : -1;
    out[k] = nonneg ? nv[k] : -1;
    const float nb = lower[k] + (nonneg ? (float)(pos[k] + 1) : (float)pos[k]) * width[k];
    next_crossing[k] = ray_t + (nb - gi) / d[k];
    delta[k] = (nonneg ? width[k] : -width[k]) / d[k];
  }

  const T od[3] = {(T)o[0], (T)o[1], (T)o[2]};
  const T dd[3] = {(T)d[0], (T)d[1], (T)d[2]};
  const T gate = (T)t_gate;
  bool any_pass = false, found = false;
  float t_min = INFINITY;
  int best = -1, steps = 0, tested = 0;
  const int max_steps = nx + ny + nz + 2;

  for (int i = 0; i < max_steps && alive; ++i) {
    // ---- test the current voxel's triangles --------------------------
    const int cell = clip(pos[2], nz) * (nx * ny) + clip(pos[1], ny) * nx + clip(pos[0], nx);
    const int start = cell_start[cell];
    const int count = cell_start[cell + 1] - start;
    tested += count;
    T vmin = (T)INFINITY;
    int vid = -1;
    for (int j = 0; j < count; ++j) {
      const int tri = tri_ids[start + j];
      const float* v = tri9 + (size_t)tri * 9;
      T e1[3], e2[3], s[3];
      for (int k = 0; k < 3; ++k) {
        const T a = (T)v[k], b = (T)v[3 + k], c = (T)v[6 + k];
        e1[k] = a - b;
        e2[k] = a - c;
        s[k] = a - od[k];
      }
      T t, beta, gamma;
      cramer_columns<T, false>(e1, e2, s, dd, t, beta, gamma);
      const bool passed = barycentric_pass(beta, gamma);
      any_pass = any_pass || passed;
      const bool cand = passed && (!has_gate || t > gate);
      if (cand && t < vmin) {
        vmin = t;
        vid = tri;
      }
    }
    if (vmin < (T)t_min) {  // cross-step compare in the det type
      t_min = (float)vmin;
      best = vid;
      found = true;
    }

    // ---- advance to the next voxel (Serial/grid.h:214-228) -----------
    const int bits = 4 * (next_crossing[0] < next_crossing[1]) +
                     2 * (next_crossing[0] < next_crossing[2]) +
                     (next_crossing[1] < next_crossing[2]);
    const int axis = kCmpToAxis[bits];
    const float ncr = next_crossing[axis];
    const float maxt_eff = early_exit ? nan_min(mx, found ? t_min : INFINITY) : mx;
    const bool move = !(maxt_eff < ncr);
    bool die_out = false;
    if (move) {
      pos[axis] += step[axis];
      die_out = pos[axis] == out[axis];
      next_crossing[axis] = next_crossing[axis] + delta[axis];
    }
    alive = move && !die_out;
    if (stop_on_first_hit) alive = alive && !found;
    ++steps;
  }

  any_pass_out[r] = any_pass;
  hit_out[r] = found;
  t_out[r] = t_min;
  tri_out[r] = best;
  steps_out[r] = steps;
  if (tested_out != nullptr) tested_out[r] = tested;
}

}  // namespace

// orig, dirn (n_rays, 3), mint, maxt (n_rays,) f32; gridf (12,) f32 =
// lower, upper, width, inv_width; cell_start (nx*ny*nz + 1,) and tri_ids
// (nnz,) i32; tri9 (F, 9) f32.  det_f64 selects double determinants.
// Writes the five TraceResult fields (bools as one byte) and, when
// tested_out is not null, the triangles each ray tested.  Returns
// cudaGetLastError() after the launch.
extern "C" int traverse_grid_launch(
    int det_f64, const float* orig, const float* dirn, const float* mint,
    const float* maxt, const float* gridf, int nx, int ny, int nz,
    const int* cell_start, const int* tri_ids, const float* tri9, int n_rays,
    int has_gate, double t_gate, int early_exit, int stop_on_first_hit,
    unsigned char* any_pass_out, unsigned char* hit_out, float* t_out,
    int* tri_out, int* steps_out, int* tested_out, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kBlock - 1) / kBlock;
    cudaStream_t s = (cudaStream_t)stream;
    if (det_f64) {
      traverse_grid_kernel<double><<<blocks, kBlock, 0, s>>>(
          orig, dirn, mint, maxt, gridf, nx, ny, nz, cell_start, tri_ids, tri9,
          n_rays, has_gate, t_gate, early_exit, stop_on_first_hit,
          any_pass_out, hit_out, t_out, tri_out, steps_out, tested_out);
    } else {
      traverse_grid_kernel<float><<<blocks, kBlock, 0, s>>>(
          orig, dirn, mint, maxt, gridf, nx, ny, nz, cell_start, tri_ids, tri9,
          n_rays, has_gate, t_gate, early_exit, stop_on_first_hit,
          any_pass_out, hit_out, t_out, tri_out, steps_out, tested_out);
    }
  }
  return (int)cudaGetLastError();
}
