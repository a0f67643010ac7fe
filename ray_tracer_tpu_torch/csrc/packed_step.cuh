// The packed-grid march step, shared by kernels C (packed_march.cu) and E
// (whitted_wave.cu): one definition of the per-lane DDA over the
// block-packed grid, the JAX package's _march_step
// (ray_tracer_tpu/ops/traverse_packed.py:152) with _slab_entry (:83).
//
// A lane holds one ray's march state (Lane).  step_fetch probes the cell
// at t_cur + max(delta, t_cur*4e-6) of a ray that is not mid-cell and
// leaps the cell's empty box or arms its rows; rows_min_warp deals the
// slots of every row the warp's lanes test in the step over the warp and
// folds each row's (t, slot) minimum to its owner; step_finish keeps the
// nearest (row, slot) and advances the row cursor.  Exactness notes are
// in packed_march.cu: every file that includes this header builds with
// -fmad=false and without fast math.
#pragma once

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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFirstMask = (1 << 21) - 1;
constexpr int kNoSlot = 1 << 30;

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

// vecmath.normalize: a * (1 / sqrt(|a|^2)); zero (and NaN-length) vectors
// scale by 0.
__device__ __forceinline__ void normalize3(const float a[3], float out[3]) {
  const float n2 = dot3(a, a);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
  for (int k = 0; k < 3; ++k) out[k] = a[k] * inv;
}

}  // namespace
