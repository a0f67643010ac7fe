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
// (cramer_pass_t).  The per-lane step itself (probe, row deal, cursor) is
// packed_step.cuh, which kernel E shares.
#include <cuda_runtime.h>
#include <float.h>

#include "packed_step.cuh"

namespace {

constexpr int kBlock = 128;
// Resident blocks an SM must hold: caps the registers at 64 a thread, so
// that half of the SM's 64 warp slots can be filled (the kernel then
// spills about 140 bytes; at 86 registers, no spills and 20 warps an SM,
// it times the same: PERF.md).
constexpr int kMinBlocks = 8;

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
