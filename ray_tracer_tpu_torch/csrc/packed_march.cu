// Kernel C: the packed-grid march, one thread per ray or a persistent wave.
//
// Replaces two lax loops of the JAX package:
//   * K2, ray_tracer_tpu/ops/traverse_packed.py:_march_step (with
//     _slab_entry, _chain_probe, _primary_exhausted and _fused_retire_rearm),
//     the lock-step DDA step over the block-packed grid, as driven by
//     traverse_packed and traverse_packed_fused_shadow;
//   * K3, ray_tracer_tpu/ops/persistent.py:persistent_trace, the W-lane
//     wave that pops rays from a cumsum queue.  Its own docstring names
//     the design it translates: the CUDA reference's persistent threads
//     popping a global atomic work queue (Parallel/raytracer.cu:177-233).
//     Here each of min(wave, R) threads pops a queue position with
//     atomicAdd, marches that ray to its end, writes its record and pops
//     again (launch mode b).  Mode a launches one thread per ray.  A ray's
//     march does not depend on which thread runs it or when, so both modes
//     give the same record, and both give the JAX loop's record: the
//     device function below is that loop's per-lane state machine.
//
// Per ray: slab entry, then steps until the ray retires or max_steps.  A
// step probes t_cur + max(delta, t_cur*4e-6), decodes the cell header (the
// inline row's last two lanes, or the cell_info word), and either leaps
// the cell's empty box or starts testing its rows, the first row in the
// same step; a lane mid-cell tests one row of block_tris triangles
// (cramer.cuh, divide variant) and keeps the nearest (row, slot): lowest
// slot on ties in a row, strict < across rows.  In fused mode a finished
// primary with a hit rearms in place as its shadow ray (serial quirk, mint,
// gate, and the dead-shadow skip with its 2e-5*sqrt(|e1|^2|e2|^2) margin);
// the shadow phase retires at its first row with an accepted hit.
//
// Exactness against the plain version (ops/traverse_packed.march_plain):
// built with -fmad=false and no fast math, so every product, sum, IEEE
// division and sqrtf rounds on its own; NaN-propagating min/max are
// written out (fminf/fmaxf drop NaN); jnp.nan_to_num's two uses are
// written out (the box exit maps NaN and +inf to FLT_MAX and -inf to
// -FLT_MAX); the float-to-int cell cast saturates with NaN -> 0 as XLA's.
//
// Bound on the H100: device-memory bytes.  Each ray reads its 32 bytes
// and writes a 15-byte record; the march reads block rows (512 B each,
// 48 MB for the turbo serial grid) and resolves one slot_tri entry per
// hit.  Counting each distinct row once, the rows this frame touches are
// a fraction of the table, a few microseconds of HBM time; the arithmetic
// (61 FP32 operations per tested triangle, 14 per row) is of the same
// order.  This first version is not near that bound: a thread walks one
// ray through dependent row reads (a latency chain), neighbouring threads
// read unrelated rows (no coalescing), and the persistent mode runs only
// `wave` threads, a TPU-tuned width that leaves most of the 132 SMs'
// warp slots empty.  It is simple and exact; ray sorting, row staging and
// a wider wave are later work (chip_smoke.py reports time and bound).
#include <cuda_runtime.h>
#include <float.h>

#include "cramer.cuh"

// The launch's scalars, passed by value from ctypes (the layout of
// ops/traverse_packed._MarchParams).  At namespace scope: a parameter of
// an unnamed-namespace type would give the extern "C" launcher internal
// linkage and drop its symbol from the library.
struct MarchParams {
  float lower[3], upper[3], width[3], inv_width[3], light[3];
  float probe_delta, gate, shadow_gate, shadow_mint;
  int nx, ny, nz, n_blocks, block_tris, row_lanes, inline_layout, n_slots;
  int fused, stop_on_first_hit, skip_dead, shade_serial, serial_quirk;
  int probe_chain, max_steps, n_rays, n_work;
};

namespace {

constexpr int kBlock = 128;
constexpr int kFirstMask = (1 << 21) - 1;

struct Outputs {
  unsigned char* hit;
  float* t;
  int* tri;
  unsigned char* in_shadow;
  int* shadow_tri;
  int* steps;
  int* tested;   // optional: rows tested per ray
  int* touched;  // optional: per row, |1 header read, |2 triangles tested
  int* capped;   // optional: rays still marching at max_steps
};

// jnp.minimum / jnp.maximum: NaN if either operand is NaN.
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

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// floor(x) as XLA's int32 cast gives it for the march's decisions: NaN ->
// 0, then clamped to [-1, n] (outside stays outside, inside is exact).
__device__ __forceinline__ int probe_cell(float x, int n) {
  float f = floorf(x);
  if (f != f) f = 0.0f;
  if (f < -1.0f) f = -1.0f;
  if (f > (float)n) f = (float)n;
  return (int)f;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// _slab_entry: entry t and entered flag.  NaN (an origin on a slab plane
// with a parallel direction) widens that axis to (-inf, +inf); rays with a
// non-finite component or a zero direction never enter.
__device__ void slab_entry(const MarchParams& P, const float o[3], const float d[3],
                           float mint, float maxt, float& t0, bool& entered) {
  float lo_max = 0.0f, hi_min = 0.0f;
  bool well = true, nonzero = false;
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / d[k];
    const float tn = (P.lower[k] - o[k]) * inv;
    const float tf = (P.upper[k] - o[k]) * inv;
    float lo = nan_min(tn, tf), hi = nan_max(tn, tf);
    if (lo != lo) lo = -INFINITY;
    if (hi != hi) hi = INFINITY;
    lo_max = (k == 0 || lo > lo_max) ? lo : lo_max;
    hi_min = (k == 0 || hi < hi_min) ? hi : hi_min;
    well = well && finite(o[k]) && finite(d[k]);
    nonzero = nonzero || d[k] != 0.0f;
  }
  t0 = nan_max(lo_max, mint);
  const float t1 = nan_min(hi_min, maxt);
  entered = (t0 <= t1) && finite(t0) && well && nonzero;
}

__device__ __forceinline__ void decode_extents(int word, int lo[3], int hi[3]) {
  const int w = word & 0x3FFFFFFF;
  lo[0] = w & 31;
  lo[1] = (w >> 10) & 31;
  lo[2] = (w >> 20) & 31;
  hi[0] = (w >> 5) & 31;
  hi[1] = (w >> 15) & 31;
  hi[2] = (w >> 25) & 31;
}

// The march state of one lane (the JAX loop's carry keys).
struct Lane {
  float o[3], d[3], invd[3];
  float gate, t_cur, t_exit_cell, best_t, p_best_t;
  int first_blk, n_blk, cursor, best_blk, best_slot, p_best_blk, p_best_slot;
  bool alive, testing, phase, shadow_hit;
  float tri9[9];  // the winning triangle, for the dead-shadow skip
};

// Probe the cell at t_cur + max(delta, t_cur*4e-6) of a lane that is not
// mid-cell.  Returns false if the probe left the grid; else fills the
// cell's header and the safe box's exit t.
__device__ bool probe(const MarchParams& P, const Lane& L, const int* cell_info,
                      const float* blocks, int* touched, float& probe_t, int& lin,
                      int& first, int& nblk, float& t_exit) {
  const int nv[3] = {P.nx, P.ny, P.nz};
  probe_t = L.t_cur + nan_max(P.probe_delta, L.t_cur * 4e-6f);
  int cell[3];
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    const float p = L.o[k] + L.d[k] * probe_t;
    cell[k] = probe_cell((p - P.lower[k]) * P.inv_width[k], nv[k]);
    inside = inside && cell[k] >= 0 && cell[k] < nv[k];
  }
  if (!inside) return false;
  lin = cell[2] * (P.nx * P.ny) + cell[1] * P.nx + cell[0];
  int word;
  if (P.inline_layout) {
    lin = clampi(lin, 0, P.n_blocks - 1);
    const float* row = blocks + (size_t)lin * P.row_lanes;
    word = __float_as_int(row[P.row_lanes - 2]);
    first = word;
    nblk = __float_as_int(row[P.row_lanes - 1]) & 0xFFFF;
    if (touched != nullptr) atomicOr(touched + lin, 1);
  } else {
    word = cell_info[lin];
    first = word & kFirstMask;
    nblk = word < 0 ? 0 : (word >> 21) & 63;
  }
  int lo[3], hi[3];
  decode_extents(word, lo, hi);
  const bool occupied = nblk > 0;
  float tmin = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const int lo_e = occupied ? 0 : lo[k];
    const int hi_e = occupied ? 0 : hi[k];
    const float blo = P.lower[k] + (float)(cell[k] - lo_e) * P.width[k];
    const float bhi = P.lower[k] + (float)(cell[k] + hi_e + 1) * P.width[k];
    float tf = nan_max((blo - L.o[k]) * L.invd[k], (bhi - L.o[k]) * L.invd[k]);
    // jnp.nan_to_num(tf, nan=inf): NaN -> inf, then +inf -> FLT_MAX, -inf -> -FLT_MAX
    if (tf != tf || tf == INFINITY) tf = FLT_MAX;
    else if (tf == -INFINITY) tf = -FLT_MAX;
    tmin = (k == 0 || tf < tmin) ? tf : tmin;
  }
  t_exit = nan_max(tmin, probe_t);
  return true;
}

// One march step (_march_step and its probe_chain - 1 extra probes).
__device__ void march_step(const MarchParams& P, Lane& L, float maxt_lane,
                           const int* cell_info, const float* blocks, int* touched,
                           int& tested) {
  bool start_test = false;
  int lin = 0;
  if (!L.testing) {  // the lane is alive: fetch
    float probe_t, t_exit;
    int first, nblk;
    if (!probe(P, L, cell_info, blocks, touched, probe_t, lin, first, nblk, t_exit)) {
      L.alive = false;  // walked off the grid
    } else if (nblk > 0) {
      start_test = true;
      L.first_blk = first;
      L.n_blk = nblk;
      L.cursor = 0;
      L.t_exit_cell = t_exit;
      L.testing = true;
    } else {
      L.t_cur = t_exit;  // leap the empty box
    }
  }
  if (L.testing) {
    // inline: the probed cell's row, or overflow row first + cursor - 1;
    // blocks: row first + cursor
    int blk;
    if (P.inline_layout) {
      blk = start_test ? lin : clampi(L.first_blk + L.cursor - 1, 0, P.n_blocks - 1);
    } else {
      blk = clampi(L.first_blk + L.cursor, 0, P.n_blocks - 1);
    }
    const float* row = blocks + (size_t)blk * P.row_lanes;
    float m = INFINITY;
    int slot = 0;
    for (int j = 0; j < P.block_tris; ++j) {
      const float* v = row + 9 * j;
      float e1[3], e2[3], s[3];
      for (int k = 0; k < 3; ++k) {
        const float a = v[k], b = v[3 + k], c = v[6 + k];
        e1[k] = a - b;
        e2[k] = a - c;
        s[k] = a - L.o[k];
      }
      float t, beta, gamma;
      cramer_columns<float, false>(e1, e2, s, L.d, t, beta, gamma);
      const bool accept = barycentric_pass(beta, gamma) && t > L.gate && t <= maxt_lane;
      if (accept && t < m) {  // first slot of the row minimum
        m = t;
        slot = j;
      }
    }
    ++tested;
    if (touched != nullptr) atomicOr(touched + blk, 2);
    if (m < L.best_t) {
      L.best_t = m;
      L.best_blk = blk;
      L.best_slot = slot;
      if (P.skip_dead) {
        for (int k = 0; k < 9; ++k) L.tri9[k] = row[9 * slot + k];
      }
    }
    L.cursor += 1;
    if (L.cursor >= L.n_blk) {
      L.testing = false;
      L.t_cur = L.t_exit_cell;
    }
  }
  // blocks layout: lanes that are still pure leapers probe again
  for (int c = 1; c < P.probe_chain; ++c) {
    if (!L.alive || L.testing) break;
    float probe_t, t_exit;
    int first, nblk, lin2;
    if (!probe(P, L, cell_info, blocks, nullptr, probe_t, lin2, first, nblk, t_exit)) {
      L.alive = false;
    } else if (nblk > 0) {
      L.first_blk = first;
      L.n_blk = nblk;
      L.cursor = 0;
      L.t_exit_cell = t_exit;
      L.testing = true;
    } else {
      L.t_cur = t_exit;
    }
  }
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// _fused_retire_rearm for a lane that ran this step (pre_alive).
__device__ void retire_rearm(const MarchParams& P, Lane& L, float maxt0) {
  const bool walked_out = !L.alive;
  const bool hit_now = finite(L.best_t);
  const float limit = nan_min(maxt0, L.best_t);
  const bool retire_primary =
      !L.phase && ((L.alive && !L.testing && L.t_cur > limit) || walked_out);
  const bool retire_shadow = L.phase && ((L.alive && hit_now) || walked_out);
  bool hit0 = retire_primary && hit_now;
  bool skip = false, s_entered = false;
  float st0 = 0.0f;
  if (hit0) {
    float poi[3], to_light[3], sdir[3];
    for (int k = 0; k < 3; ++k) {
      poi[k] = L.o[k] + L.d[k] * L.best_t;
      to_light[k] = P.light[k] - poi[k];
    }
    const float norm = sqrtf(dot3(to_light, to_light));
    const float den = norm > 0.0f ? norm : 1.0f;
    for (int k = 0; k < 3; ++k) sdir[k] = to_light[k] / den;
    if (P.skip_dead) {
      const float* a = L.tri9;
      const float* b = L.tri9 + 3;
      const float* c = L.tri9 + 6;
      float ab[3], ca[3], cb[3], n[3], h[3];
      for (int k = 0; k < 3; ++k) {
        ab[k] = a[k] - b[k];
        ca[k] = c[k] - a[k];
        cb[k] = c[k] - b[k];
        h[k] = sdir[k] - L.d[k];
      }
      if (P.shade_serial) {
        cross3(ab, ca, n);  // getNormalMod, Serial/geometry.h:234-240
      } else {
        cross3(cb, ab, n);  // Parallel/geometry.cuh:160
      }
      const float m = 2e-5f * sqrtf(dot3(ab, ab) * dot3(ca, ca));
      const bool dead = (dot3(n, sdir) <= -m) && (dot3(n, h) <= -m);
      skip = dead;
      hit0 = !dead;
    }
    if (hit0) {
      for (int k = 0; k < 3; ++k) {
        L.o[k] = poi[k];
        L.d[k] = P.serial_quirk ? -sdir[k] : sdir[k];  // serial: away from the light
      }
      slab_entry(P, L.o, L.d, P.shadow_mint, INFINITY, st0, s_entered);
    }
  }
  const bool done =
      (retire_primary && !hit_now) || (hit0 && !s_entered) || skip || retire_shadow;
  if (retire_shadow && hit_now) L.shadow_hit = true;
  if (retire_primary) {
    L.p_best_t = L.best_t;
    L.p_best_blk = L.best_blk;
    L.p_best_slot = L.best_slot;
  }
  if (hit0) {
    L.phase = true;
    L.gate = P.shadow_gate;
    L.best_t = INFINITY;
    L.best_blk = 0;
    L.best_slot = 0;
    L.t_cur = st0;
    L.cursor = 0;
    for (int k = 0; k < 3; ++k) L.invd[k] = 1.0f / L.d[k];
  }
  L.testing = L.testing && !hit0 && !done;
  L.alive = (L.alive || hit0) && !done;
}

__device__ __forceinline__ int slot_tri_of(const MarchParams& P, const int* slot_tri,
                                           int blk, int slot) {
  return slot_tri[clampi(blk * P.block_tris + slot, 0, P.n_slots - 1)];
}

// March ray r to its end and write its record; returns its steps.
__device__ int march_ray(const MarchParams& P, int r, const float* orig,
                         const float* dirn, const float* mint, const float* maxt,
                         const int* cell_info, const float* blocks,
                         const int* slot_tri, const Outputs& out) {
  Lane L;
  for (int k = 0; k < 3; ++k) {
    L.o[k] = orig[3 * r + k];
    L.d[k] = dirn[3 * r + k];
    L.invd[k] = 1.0f / L.d[k];
  }
  const float maxt0 = maxt[r];
  float t0;
  bool entered;
  slab_entry(P, L.o, L.d, mint[r], maxt0, t0, entered);
  L.gate = P.gate;
  L.t_cur = t0;
  L.t_exit_cell = 0.0f;
  L.best_t = INFINITY;
  L.p_best_t = INFINITY;
  L.first_blk = L.n_blk = L.cursor = 0;
  L.best_blk = L.best_slot = L.p_best_blk = L.p_best_slot = 0;
  L.alive = entered;
  L.testing = L.phase = L.shadow_hit = false;
  for (int k = 0; k < 9; ++k) L.tri9[k] = 0.0f;

  int steps = 0, tested = 0;
  for (int i = 0; i < P.max_steps && L.alive; ++i) {
    // shadow rays march unbounded; the primary keeps its own maxt
    const float maxt_lane = (P.fused && L.phase) ? INFINITY : maxt0;
    march_step(P, L, maxt_lane, cell_info, blocks, out.touched, tested);
    if (P.fused) {
      retire_rearm(P, L, maxt0);
    } else {
      const float limit = nan_min(maxt0, L.best_t);
      L.alive = L.alive && (L.testing || L.t_cur <= limit);
      if (P.stop_on_first_hit) {
        L.alive = L.alive && !finite(L.best_t);
        L.testing = L.testing && L.alive;
      }
    }
    ++steps;
  }
  if (L.alive && out.capped != nullptr) atomicAdd(out.capped, 1);

  bool hit, shadow = false;
  float t;
  int tri, stri = -1;
  if (!P.fused) {
    t = L.best_t;
    hit = finite(t);
    tri = hit ? slot_tri_of(P, slot_tri, L.best_blk, L.best_slot) : -1;
  } else {
    t = L.phase ? L.p_best_t : L.best_t;
    const int blk = L.phase ? L.p_best_blk : L.best_blk;
    const int slot = L.phase ? L.p_best_slot : L.best_slot;
    hit = finite(t);
    tri = hit ? slot_tri_of(P, slot_tri, blk, slot) : -1;
    // a shadow lane still marching at the cap with a blocker counts
    shadow = L.shadow_hit || (L.phase && finite(L.best_t));
    if (shadow && L.phase) stri = slot_tri_of(P, slot_tri, L.best_blk, L.best_slot);
  }
  out.hit[r] = hit;
  out.t[r] = t;
  out.tri[r] = tri;
  out.in_shadow[r] = shadow && hit;
  out.shadow_tri[r] = stri;
  out.steps[r] = steps;
  if (out.tested != nullptr) out.tested[r] = tested;
  return steps;
}

__global__ void __launch_bounds__(kBlock)
packed_march_kernel(MarchParams P, const float* __restrict__ orig,
                    const float* __restrict__ dirn, const float* __restrict__ mint,
                    const float* __restrict__ maxt, const int* __restrict__ cell_info,
                    const float* __restrict__ blocks, const int* __restrict__ slot_tri,
                    const int* __restrict__ queue, int* counter, Outputs out,
                    int threads, int* iters) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int total = 0;
  if (threads == 0) {  // mode a: one thread per ray
    if (tid >= P.n_rays) return;
    total = march_ray(P, tid, orig, dirn, mint, maxt, cell_info, blocks, slot_tri, out);
  } else {  // mode b: persistent threads popping the queue
    if (tid >= threads) return;
    for (;;) {
      const int k = atomicAdd(counter, 1);
      if (k >= P.n_work) break;
      const int r = queue != nullptr ? queue[k] : k;
      total += march_ray(P, r, orig, dirn, mint, maxt, cell_info, blocks, slot_tri, out);
    }
  }
  if (iters != nullptr) atomicMax(iters, total);
}

}  // namespace

// Launch kernel C.  Rays orig/dirn (n_rays, 3), mint/maxt (n_rays,) f32;
// cell_info (n_cells,) or (1,) i32, blocks (n_blocks, row_lanes) f32,
// slot_tri (n_slots,) i32.  threads == 0: one thread per ray; threads > 0:
// that many persistent threads pop positions [0, n_work) of `queue` (ray
// ids; identity when null) through *counter, which the caller zeroes.
// The caller pre-fills the outputs with the miss record, which rays never
// popped keep.  Returns cudaGetLastError() after the launch.
extern "C" int packed_march_launch(
    MarchParams P, const float* orig, const float* dirn, const float* mint,
    const float* maxt, const int* cell_info, const float* blocks,
    const int* slot_tri, const int* queue, int* counter, unsigned char* hit,
    float* t, int* tri, unsigned char* in_shadow, int* shadow_tri, int* steps,
    int* tested, int* touched, int* capped, int threads, int* iters,
    void* stream) {
  const int n = threads > 0 ? threads : P.n_rays;
  if (n > 0) {
    Outputs out{hit, t, tri, in_shadow, shadow_tri, steps, tested, touched, capped};
    const int blocks_n = (n + kBlock - 1) / kBlock;
    packed_march_kernel<<<blocks_n, kBlock, 0, (cudaStream_t)stream>>>(
        P, orig, dirn, mint, maxt, cell_info, blocks, slot_tri, queue, counter, out,
        threads, iters);
  }
  return (int)cudaGetLastError();
}
