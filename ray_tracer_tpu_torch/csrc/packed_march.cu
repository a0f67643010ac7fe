// Kernel C: the packed-grid march, a lane per ray, the warp sharing the rows.
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
//
// Per ray: slab entry, then steps until the ray retires or max_steps.  A
// step probes t_cur + max(delta, t_cur*4e-6), decodes the cell header (the
// inline row's last two lanes, or the cell_info word), and either leaps
// the cell's empty box or starts testing its rows, the first row in the
// same step; a ray mid-cell tests one row of block_tris triangles
// (cramer.cuh, divide variant) and keeps the nearest (row, slot): lowest
// slot on ties in a row, strict < across rows.  In fused mode a finished
// primary with a hit rearms in place as its shadow ray (serial quirk, mint,
// gate, and the dead-shadow skip with its 2e-5*sqrt(|e1|^2|e2|^2) margin);
// the shadow phase retires at its first row with an accepted hit.
//
// Design.  Each lane of a warp marches its own ray through the JAX loop's
// per-lane state machine (probe, leap, t_exit, retire/rearm), and the
// warp shares out the row tests: the block_tris slots of every row its
// lanes test in a step are dealt out 32 at a time in lane order, each lane
// tests one slot with the row owner's ray (so neighbouring lanes read
// neighbouring triangles of one row), and a segmented butterfly of (t,
// slot) pairs, smaller t first and then lower slot, gives each owner the
// sequential loop's "first slot of the row minimum": accepted t are never
// NaN, so the fold is order-free.  The launch gives one lane to each queue
// position and leaves the residency to the card's block scheduler.  A
// ray's march does not depend on which lane runs it or when, so the record
// is the JAX loop's.  On the H100 this measured faster than a group of G
// lanes a ray (G = 1, 8, 16, 32: the group's lanes all repeat the probe
// and the retire) and than resident lanes popping positions from an atomic
// counter (PERF.md).
//
// Exactness against the plain version (ops/traverse_packed.march_plain):
// built with -fmad=false and no fast math, so every product, sum, IEEE
// division and sqrtf rounds on its own; NaN-propagating min/max are
// written out (fminf/fmaxf drop NaN); jnp.nan_to_num's two uses are
// written out (the box exit maps NaN and +inf to FLT_MAX and -inf to
// -FLT_MAX); the float-to-int cell cast saturates with NaN -> 0 as XLA's.
//
// Bound on the H100: device-memory bytes and FP32 operations, close to
// level on the turbo serial frame (chip_smoke.py reports both): each ray
// reads its 32 bytes and writes its record, the march reads each distinct
// row it tests once, and every tested slot costs a Cramer test at the
// unfused FP32 rate, t's numerator and division only where the
// barycentric test passes.  The kernel stands far from it, bound by
// instruction issue: a warp runs until its longest ray ends (a mean of
// 2.35 steps a ray against a maximum of 62 on that frame) and executes the
// union of its lanes' paths.  Sharing the row tests spreads a row's solves over the
// warp's lanes instead of one lane's loop, and t's numerator and division
// are computed only for a triangle that passes the barycentric test
// (cramer_pass_t).
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
constexpr unsigned kFull = 0xffffffffu;
// Resident blocks an SM must hold: caps the registers at 64 a thread, so
// that half of the SM's 64 warp slots can be filled (the kernel then
// spills about 140 bytes; at 86 registers, no spills and 20 warps an SM,
// it times the same: PERF.md).
constexpr int kMinBlocks = 8;
constexpr int kFirstMask = (1 << 21) - 1;
constexpr int kNoSlot = 1 << 30;

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
  int* passes;   // optional: tested slots that passed the barycentric test
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

// The march state of one ray (the JAX loop's carry keys).
struct Lane {
  float o[3], d[3], invd[3];
  float gate, t_cur, t_exit_cell, best_t, p_best_t;
  int first_blk, n_blk, cursor, best_blk, best_slot, p_best_blk, p_best_slot;
  bool alive, testing, phase, shadow_hit;
  float tri9[9];  // the winning triangle, for the dead-shadow test
};

// Probe the cell at t_cur + max(delta, t_cur*4e-6) of a ray that is not
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

// Slot j of the row against the ray: its t if accepted and below +inf
// (t, j), else (+inf, kNoSlot).  Accepted t are never NaN.  Returns
// whether the barycentric test passed.
__device__ __forceinline__ bool test_slot(const float* row, int j, const float o[3],
                                          const float d[3], float gate, float maxt_lane,
                                          float& t_out, int& slot_out) {
  const float* v = row + 9 * j;
  float e1[3], e2[3], s[3];
  for (int k = 0; k < 3; ++k) {
    const float a = v[k], b = v[3 + k], c = v[6 + k];
    e1[k] = a - b;
    e2[k] = a - c;
    s[k] = a - o[k];
  }
  float t;
  const bool passed = cramer_pass_t(e1, e2, s, d, t);
  const bool take = passed && t > gate && t <= maxt_lane && t < INFINITY;
  t_out = take ? t : INFINITY;
  slot_out = take ? j : kNoSlot;
  return passed;
}

// (t, slot) <- the lexicographic minimum: smaller t, then lower slot.
__device__ __forceinline__ void lex_min(float& t, int& slot, float ot, int os) {
  if (ot < t || (ot == t && os < slot)) {
    t = ot;
    slot = os;
  }
}

// The rows of a step: each lane marches its own ray, and the slots of
// every row a lane tests this step (blk >= 0) are dealt out 32 at a time
// in lane order; each lane tests one slot with its owner's ray, and a
// segmented butterfly takes each row's lexicographic (t, slot) minimum to
// its first lane of the round, which the owner reads; slot is 0 when
// nothing was accepted (m = +inf), as in the sequential loop.  Every lane
// of the warp calls it.  `passes`, when not null, counts the slots whose
// barycentric test passed.
__device__ void rows_min_warp(const MarchParams& P, const float* blocks, int blk,
                              const Lane& L, float maxt_lane, int* passes, float& m,
                              int& slot) {
  const int lane = threadIdx.x & 31;
  const unsigned testers = __ballot_sync(kFull, blk >= 0);
  m = INFINITY;
  slot = kNoSlot;
  const int bt = P.block_tris;
  const int pairs = __popc(testers) * bt;
  const int first = __popc(testers & ((1u << lane) - 1u)) * bt;  // my row's first pair
  for (int base = 0; base < pairs; base += 32) {
    const int q = base + lane;
    const int rank = q / bt;
    const int owner = (int)(__fns(testers, 0, rank + 1) & 31u);
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = __shfl_sync(kFull, L.o[k], owner);
      d[k] = __shfl_sync(kFull, L.d[k], owner);
    }
    const float gate = __shfl_sync(kFull, L.gate, owner);
    const float mx = __shfl_sync(kFull, maxt_lane, owner);
    const int row = __shfl_sync(kFull, blk, owner);
    float t = INFINITY;
    int s = kNoSlot;
    bool passed = false;
    if (q < pairs) {
      passed = test_slot(blocks + (size_t)row * P.row_lanes, q - rank * bt, o, d, gate, mx,
                         t, s);
    }
    if (passes != nullptr) {
      const unsigned passers = __ballot_sync(kFull, passed);
      if (lane == 0 && passers != 0u) atomicAdd(passes, __popc(passers));
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ot = __shfl_down_sync(kFull, t, off);
      const int os = __shfl_down_sync(kFull, s, off);
      const int orank = __shfl_down_sync(kFull, rank, off);
      if (orank == rank) lex_min(t, s, ot, os);
    }
    const int head = first > base ? first - base : 0;
    const float rt = __shfl_sync(kFull, t, head & 31);
    const int rs = __shfl_sync(kFull, s, head & 31);
    if (blk >= 0 && first < base + 32 && first + bt > base) lex_min(m, slot, rt, rs);
  }
  if (!(m < INFINITY)) slot = 0;
}

// The fetch half of a march step (_march_step): a ray not mid-cell probes
// and leaps or arms its cell.  Returns the row the step tests, or -1.
__device__ int step_fetch(const MarchParams& P, Lane& L, const int* cell_info,
                          const float* blocks, int* touched) {
  bool start_test = false;
  int lin = 0;
  if (!L.testing) {  // the ray is alive: fetch
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
  if (!L.testing) return -1;
  // inline: the probed cell's row, or overflow row first + cursor - 1;
  // blocks: row first + cursor
  if (P.inline_layout) {
    return start_test ? lin : clampi(L.first_blk + L.cursor - 1, 0, P.n_blocks - 1);
  }
  return clampi(L.first_blk + L.cursor, 0, P.n_blocks - 1);
}

// The rest of the step: take row blk's (m, slot) (blk >= 0), then the
// probe_chain - 1 extra probes of a ray that is still a pure leaper.
__device__ void step_finish(const MarchParams& P, Lane& L, int blk, float m, int slot,
                            const int* cell_info, const float* blocks, int* touched,
                            int& tested) {
  if (blk >= 0) {
    ++tested;
    if (touched != nullptr) atomicOr(touched + blk, 2);
    if (m < L.best_t) {
      L.best_t = m;
      L.best_blk = blk;
      L.best_slot = slot;
      if (P.skip_dead) {
        const float* row = blocks + (size_t)blk * P.row_lanes;
        for (int k = 0; k < 9; ++k) L.tri9[k] = row[9 * slot + k];
      }
    }
    L.cursor += 1;
    if (L.cursor >= L.n_blk) {
      L.testing = false;
      L.t_cur = L.t_exit_cell;
    }
  }
  for (int c = 1; c < P.probe_chain; ++c) {  // blocks layout only
    if (!L.alive || L.testing) break;
    float probe_t, t_exit;
    int first, nblk, lin2;
    if (!probe(P, L, cell_info, blocks, (int*)nullptr, probe_t, lin2, first, nblk, t_exit)) {
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

// _fused_retire_rearm for a ray that ran this step (pre_alive).
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

// Load ray r into the march state; returns its own maxt.
__device__ float start_ray(const MarchParams& P, int r, const float* orig,
                           const float* dirn, const float* mint, const float* maxt,
                           Lane& L) {
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
  return maxt0;
}

// Retirement after a step: the fused rearm, or the nearest/any-hit rule.
__device__ __forceinline__ void after_step(const MarchParams& P, Lane& L, float maxt0) {
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
}

// Write ray r's record.
__device__ void finish_ray(const MarchParams& P, const Lane& L, int r, int steps,
                           int tested, const int* slot_tri, const Outputs& out) {
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
    // a shadow ray still marching at the cap with a blocker counts
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
}

// Each lane marches the ray at its queue position step by step, and the
// warp shares out the row tests of each step (rows_min_warp); a lane whose
// ray has ended keeps dealing slots until the warp's last ray ends.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
packed_march_kernel(MarchParams P, const float* __restrict__ orig,
                    const float* __restrict__ dirn, const float* __restrict__ mint,
                    const float* __restrict__ maxt, const int* __restrict__ cell_info,
                    const float* __restrict__ blocks, const int* __restrict__ slot_tri,
                    const int* __restrict__ queue, Outputs out, int* iters) {
  Lane L;
  const int position = blockIdx.x * kBlock + threadIdx.x;
  int r = 0, steps = 0, tested = 0;
  float maxt0 = 0.0f;
  bool has_ray = false;
  if (position < P.n_work) {
    r = queue != nullptr ? queue[position] : position;
    maxt0 = start_ray(P, r, orig, dirn, mint, maxt, L);
    if (L.alive && P.max_steps > 0) {
      has_ray = true;
    } else {
      finish_ray(P, L, r, 0, 0, slot_tri, out);
    }
  }
  while (__any_sync(kFull, has_ray)) {
    // shadow rays march unbounded; the primary keeps its own maxt
    const float maxt_lane = (P.fused && L.phase) ? INFINITY : maxt0;
    const int blk = has_ray ? step_fetch(P, L, cell_info, blocks, out.touched) : -1;
    float m;
    int slot;
    rows_min_warp(P, blocks, blk, L, maxt_lane, out.passes, m, slot);
    if (!has_ray) continue;
    step_finish(P, L, blk, m, slot, cell_info, blocks, out.touched, tested);
    after_step(P, L, maxt0);
    ++steps;
    if (!L.alive || steps >= P.max_steps) {
      finish_ray(P, L, r, steps, tested, slot_tri, out);
      has_ray = false;
    }
  }
  if (iters != nullptr) atomicMax(iters, steps);
}

}  // namespace

// Launch kernel C.  Rays orig/dirn (n_rays, 3), mint/maxt (n_rays,) f32;
// cell_info (n_cells,) or (1,) i32, blocks (n_blocks, row_lanes) f32,
// slot_tri (n_slots,) i32.  Positions [0, n_work) of `queue` (ray ids;
// identity when null) are marched, one lane a position.  The caller
// pre-fills the outputs with the miss record, which rays never served
// keep, and zeroes the optional counters (tested, touched, capped,
// passes, iters: null when not wanted).  Returns cudaGetLastError() after
// the launch.
extern "C" int packed_march_launch(
    MarchParams P, const float* orig, const float* dirn, const float* mint,
    const float* maxt, const int* cell_info, const float* blocks,
    const int* slot_tri, const int* queue, unsigned char* hit, float* t, int* tri,
    unsigned char* in_shadow, int* shadow_tri, int* steps, int* tested, int* touched,
    int* capped, int* passes, int* iters, void* stream) {
  const Outputs out{hit, t, tri, in_shadow, shadow_tri, steps, tested, touched, capped, passes};
  const long long grid = ((long long)P.n_work + kBlock - 1) / kBlock;
  if (grid > 0) {
    packed_march_kernel<<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(
        P, orig, dirn, mint, maxt, cell_info, blocks, slot_tri, queue, out, iters);
  }
  return (int)cudaGetLastError();
}
