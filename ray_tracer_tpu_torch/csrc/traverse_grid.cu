// Kernel B: the CSR uniform-grid 3D-DDA, one thread per ray.
//
// Replaces the lock-step lax.while_loop of
// ray_tracer_tpu/ops/traverse.py:traverse_grid (with its entry setup
// _dda_setup), the port of the reference's per-ray grid walk
// (Serial/grid.h:167-231).  Each thread walks its own ray and gives the
// lock-step loop's answers exactly:
//   * per voxel, the candidate with the smallest t in the determinant type
//     (first CSR index on ties) replaces the record only if it is below
//     the float32 running minimum, compared in the determinant type
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
//     it walked (traverse.py:110, 196).
// Two types are template parameters, four instantiations chosen at launch:
//   * R, the rays' own type (float, or double under dtype="float64"): the
//     entry setup, the slab test, the entry point, next_crossing and delta
//     run in it, with the float32 grid bounds and widths widened as XLA
//     promotes them (traverse.py:60-84); the running minimum t_min stays
//     float32 and meets R only in the early-exit maxt (traverse.py:181);
//   * T, the determinants' (det_dtype): the rays are narrowed to it for the
//     Cramer solve (intersect.py:45-49), and a voxel's minimum meets the
//     float32 t_min in T (traverse.py:163).
// The grid tables are float32 in every instantiation, as in the JAX code.
//
// Bound on the H100: FP32 operations at the unfused rate (48 a tested
// triangle that fails the barycentric test, 61 one that passes), above the
// bytes (the rays in and the five results out, 46 bytes a ray, plus the
// CSR arrays and the vertex table, each read once); chip_smoke.py reports
// both.  The walk reads port-side tables derived from the CSR grid once
// (ops/traverse.py dda_tables):
//   * a one-bit-per-cell occupancy mask, read through L1, so an empty
//     voxel (92% of the serial grid's cells) costs no global load (staging
//     it into shared memory with cp.async timed the same: PERF.md);
//   * an (start, count) int2 per cell, one 8-byte load for an occupied one;
//   * the vertices in CSR order (tri9[tri_ids]), so a voxel's triangles are
//     contiguous; the winning CSR position becomes a triangle id once, at
//     the end.
// The DDA's state stays in registers (its axis selects, never indexes
// memory), and t's numerator and division are computed only for a
// triangle that passes the barycentric test (cramer_pass_t).  The DDA
// arithmetic is untouched: every walked voxel still advances next_crossing
// and counts in `steps`, so every record is unchanged.  What is left is
// the triangle tests, about 77% of the kernel's time on the H100
// (PERF.md); sharing them out over the warp timed the same per frame and
// is not kept.  The double-precision determinants run at the H100's FP64
// rate; wgmma does not apply: the contraction depth is 3.
#include <cuda_runtime.h>

#include "cramer.cuh"

namespace {

constexpr int kBlock = 512;
// Registers capped for two resident blocks an SM (64 a thread): half the
// warp slots; the f32 kernel needs 56, no spills.
constexpr int kMinBlocks = 2;
// The cmpToAxis LUT [2,1,2,1,2,2,0,0], two bits an entry.
constexpr unsigned kCmpToAxis = 0xA66u;

// torch.minimum / jnp.minimum: NaN if either operand is NaN.
template <typename R>
__device__ __forceinline__ R nan_min(R a, R b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

template <typename R>
__device__ __forceinline__ R nan_max(R a, R b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// float or double -> cell index, XLA's conversion to int32: NaN -> 0,
// saturate, truncate toward zero; then the clip.
template <typename R>
__device__ __forceinline__ int to_cell(R f, int n) {
  if (f != f) f = R(0);
  if (f < R(-1)) f = R(-1);
  if (f > (R)n) f = (R)n;
  const int p = (int)f;
  return p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
}

__device__ __forceinline__ int clip(int p, int n) {
  return p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
}

// The voxel's triangles against the ray, in CSR order: the smallest
// candidate t (first CSR index on ties), whether any passed, and how
// many passed (added to n_pass).
template <typename T>
__device__ __forceinline__ void voxel_min(const float* __restrict__ cell_tri9,
                                          const T od[3], const T dd[3], int start,
                                          int count, bool has_gate, T gate, T& vmin,
                                          int& vpos, bool& vpass, int& n_pass) {
  for (int j = start; j < start + count; ++j) {
    const float* v = cell_tri9 + (size_t)j * 9;
    T e1[3], e2[3], s[3];
    for (int k = 0; k < 3; ++k) {
      const T a = (T)__ldg(v + k), b = (T)__ldg(v + 3 + k), c = (T)__ldg(v + 6 + k);
      e1[k] = a - b;
      e2[k] = a - c;
      s[k] = a - od[k];
    }
    T t;
    const bool passed = cramer_pass_t(e1, e2, s, dd, t);
    vpass = vpass || passed;
    n_pass += passed;
    if (passed && (!has_gate || t > gate) && t < vmin) {
      vmin = t;
      vpos = j;
    }
  }
}

template <typename R, typename T>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
traverse_grid_kernel(const R* __restrict__ orig,
                     const R* __restrict__ dirn,
                     const R* __restrict__ mint,
                     const R* __restrict__ maxt,
                     const float* __restrict__ gridf,  // lower, upper, width, inv_width
                     int nx, int ny, int nz,
                     const unsigned* __restrict__ occupancy,
                     const int2* __restrict__ cell_range,  // (start, count) a cell
                     const float* __restrict__ cell_tri9,  // (nnz, 9) in CSR order
                     const int* __restrict__ tri_ids,
                     int n_rays, int has_gate, double t_gate, int early_exit,
                     int stop_on_first_hit, unsigned char* __restrict__ any_pass_out,
                     unsigned char* __restrict__ hit_out, float* __restrict__ t_out,
                     int* __restrict__ tri_out, int* __restrict__ steps_out,
                     int* __restrict__ tested_out, int* __restrict__ passes_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int nv[3] = {nx, ny, nz};
  R lower[3], upper[3], width[3], inv_width[3], o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    lower[k] = (R)gridf[k];
    upper[k] = (R)gridf[3 + k];
    width[k] = (R)gridf[6 + k];
    inv_width[k] = (R)gridf[9 + k];
    o[k] = orig[3 * r + k];
    d[k] = dirn[3 * r + k];
  }
  const R mn = mint[r], mx = maxt[r];

  // ---- grid entry (_dda_setup, Serial/grid.h:170-203) ----------------
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    const R p = o[k] + d[k] * mn;
    inside = inside && (p >= lower[k]) && (p <= upper[k]);
  }
  R t0 = mn, t1 = mx;  // slab test, Serial/geometry.h:291-315
  for (int k = 0; k < 3; ++k) {
    const R inv = R(1) / d[k];
    const R tn = (lower[k] - o[k]) * inv;
    const R tf = (upper[k] - o[k]) * inv;
    const R lo = nan_min(tn, tf), hi = nan_max(tn, tf);
    t0 = lo > t0 ? lo : t0;
    t1 = hi < t1 ? hi : t1;
  }
  const R ray_t = inside ? mn : t0;
  bool alive = inside || (t0 <= t1);

  int pos[3], step[3], out[3];
  R next_crossing[3], delta[3];
  for (int k = 0; k < 3; ++k) {
    const R gi = o[k] + d[k] * ray_t;
    pos[k] = to_cell((gi - lower[k]) * inv_width[k], nv[k]);
    const bool nonneg = d[k] >= R(0);
    step[k] = nonneg ? 1 : -1;
    out[k] = nonneg ? nv[k] : -1;
    const R nb = lower[k] + (nonneg ? (R)(pos[k] + 1) : (R)pos[k]) * width[k];
    next_crossing[k] = ray_t + (nb - gi) / d[k];
    delta[k] = (nonneg ? width[k] : -width[k]) / d[k];
  }

  const T od[3] = {(T)o[0], (T)o[1], (T)o[2]};
  const T dd[3] = {(T)d[0], (T)d[1], (T)d[2]};
  const T gate = (T)t_gate;
  bool any_pass = false, found = false;
  float t_min = INFINITY;
  int best_pos = 0, steps = 0, tested = 0, n_pass = 0;
  const int max_steps = nx + ny + nz + 2;

  for (int i = 0; i < max_steps && alive; ++i) {
    // ---- the current voxel's triangles: (start, count) if occupied ------
    int start = 0, count = 0;
    const int cell = clip(pos[2], nz) * (nx * ny) + clip(pos[1], ny) * nx + clip(pos[0], nx);
    if ((__ldg(occupancy + (cell >> 5)) >> (cell & 31)) & 1u) {
      const int2 range = __ldg(cell_range + cell);
      start = range.x;
      count = range.y;
    }
    tested += count;
    T vmin = (T)INFINITY;
    int vpos = 0;
    bool vpass = false;
    voxel_min<T>(cell_tri9, od, dd, start, count, has_gate, gate, vmin, vpos, vpass, n_pass);
    any_pass = any_pass || vpass;
    if (vmin < (T)t_min) {  // cross-step compare in the det type
      t_min = (float)vmin;
      best_pos = vpos;
      found = true;
    }

    // ---- advance to the next voxel (Serial/grid.h:214-228) -----------
    // The axis indexes the state through selects, never through memory.
    const int bits = 4 * (next_crossing[0] < next_crossing[1]) +
                     2 * (next_crossing[0] < next_crossing[2]) +
                     (next_crossing[1] < next_crossing[2]);
    const int axis = (kCmpToAxis >> (2 * bits)) & 3;
    const R ncr = axis == 0 ? next_crossing[0]
                            : (axis == 1 ? next_crossing[1] : next_crossing[2]);
    // maxt meets the float32 record in the rays' type (traverse.py:181)
    const R maxt_eff = early_exit ? nan_min(mx, found ? (R)t_min : (R)INFINITY) : mx;
    const bool move = !(maxt_eff < ncr);
    bool die_out = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (move && k == axis) {
        pos[k] += step[k];
        die_out = pos[k] == out[k];
        next_crossing[k] = next_crossing[k] + delta[k];
      }
    }
    alive = move && !die_out;
    if (stop_on_first_hit) alive = alive && !found;
    ++steps;
  }
  any_pass_out[r] = any_pass;
  hit_out[r] = found;
  t_out[r] = t_min;
  tri_out[r] = found ? tri_ids[best_pos] : -1;
  steps_out[r] = steps;
  if (tested_out != nullptr) tested_out[r] = tested;
  if (passes_out != nullptr && n_pass > 0) atomicAdd(passes_out, n_pass);
}

}  // namespace

// orig, dirn (n_rays, 3), mint, maxt (n_rays,): float, or double when
// ray_f64; gridf (12,) f32 = lower, upper, width, inv_width; occupancy
// (ceil(n_cells / 32),) u32, bit c&31 of word c>>5 set iff cell c holds a
// triangle; cell_range (nx*ny*nz, 2) i32 = (cell_start, count); cell_tri9
// (nnz, 9) f32 = tri9[tri_ids]; tri_ids (nnz,) i32.  det_f64 selects double
// determinants.  Writes the five TraceResult fields (bools as one byte, t as
// float32); when not null, tested_out (n_rays,) receives the triangles each
// ray tested, and passes_out (1,), which the caller zeroes, the count of
// tested triangles that passed the barycentric test.  Returns
// cudaGetLastError() after the launch.
template <typename R>
static void launch(int det_f64, const void* orig, const void* dirn, const void* mint,
                   const void* maxt, const float* gridf, int nx, int ny, int nz,
                   const unsigned* occupancy, const int2* range, const float* cell_tri9,
                   const int* tri_ids, int n_rays, int has_gate, double t_gate,
                   int early_exit, int stop_on_first_hit, unsigned char* any_pass_out,
                   unsigned char* hit_out, float* t_out, int* tri_out, int* steps_out,
                   int* tested_out, int* passes_out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_rays + kBlock - 1) / kBlock);
  const auto kernel =
      det_f64 ? traverse_grid_kernel<R, double> : traverse_grid_kernel<R, float>;
  kernel<<<blocks, kBlock, 0, stream>>>(
      static_cast<const R*>(orig), static_cast<const R*>(dirn), static_cast<const R*>(mint),
      static_cast<const R*>(maxt), gridf, nx, ny, nz, occupancy, range, cell_tri9, tri_ids,
      n_rays, has_gate, t_gate, early_exit, stop_on_first_hit, any_pass_out, hit_out, t_out,
      tri_out, steps_out, tested_out, passes_out);
}

extern "C" int traverse_grid_launch(
    int ray_f64, int det_f64, const void* orig, const void* dirn, const void* mint,
    const void* maxt, const float* gridf, int nx, int ny, int nz,
    const unsigned* occupancy, const int* cell_range, const float* cell_tri9,
    const int* tri_ids, int n_rays, int has_gate, double t_gate, int early_exit,
    int stop_on_first_hit, unsigned char* any_pass_out, unsigned char* hit_out, float* t_out,
    int* tri_out, int* steps_out, int* tested_out, int* passes_out, void* stream) {
  if (n_rays > 0) {
    const int2* range = reinterpret_cast<const int2*>(cell_range);
    const auto go = ray_f64 ? launch<double> : launch<float>;
    go(det_f64, orig, dirn, mint, maxt, gridf, nx, ny, nz, occupancy, range, cell_tri9,
       tri_ids, n_rays, has_gate, t_gate, early_exit, stop_on_first_hit, any_pass_out, hit_out,
       t_out, tri_out, steps_out, tested_out, passes_out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
