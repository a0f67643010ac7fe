// Kernel F: the cross-depth GI wave, as a primary stage, a persistent wave
// of uniform sample paths and a fold.
//
// Replaces K6, ray_tracer_tpu/ops/gi_wave.py:gi_wave_trace (:96), the lax
// while_loop in which W lanes pop pixels from a cumsum queue and serve
//
//     primary march -> NEE shadow -> bounce (sample 0) -> NEE -> ... ->
//     restart at the shared depth-0 vertex (sample 1) -> ... -> radiance
//
// and write the radiance summed over the S samples of each pixel (the
// caller divides by S).
//
// Per segment: the slab entry, then march steps through packed_step.cuh
// and, after every step, the JAX loop's transition (gi_wave.py:345-743):
//   * a path segment retires when it walks past min(maxt, best_t) between
//     cells, walks off the grid, or has stepped more than seg_bound times.
//     On a hit the vertex resolves through slot_tri and its (F, 10)
//     triangle row: t recomputed (cramer_t_safe) for the integrator's
//     point, the face normal oriented against the ray (with smooth normals
//     the face's corner normals interpolated at the hit's barycentrics,
//     cramer_bg_safe, and normalized twice), the albedo row (with a
//     texture the raw base color times the texture factor, clipped to
//     [0, 1]), the NEE term tpt * albedo/pi * I*cos/d^2 and, with the
//     mirror mix, the branch draw u3 < km.  A diffuse vertex with cos > 0 (and any vertex
//     at depth 0, whose NEE settles d0, shared by every sample) rearms as
//     its NEE shadow ray from the march's own hit point; else its NEE is
//     banked at once.  On a miss a bounce's radiance takes the background,
//     or the environment map by the normalized direction.
//   * a shadow segment retires at its first accepted hit, off the grid or
//     at the step bound, and banks its staged NEE when unoccluded.
//   * a vertex below depth D bounces: a cosine-weighted direction (or the
//     mirror direction) from the hash of (pixel, sample, depth); a bounce
//     that misses the grid takes the background (or the environment) at
//     once.
// Contribution order is the JAX wave's: rad = ((0 + v_0) + v_1) + ..., each
// v_s built escape/NEE-in-depth-order; a pixel whose primary misses sums
// the background S times (bg_acc, made on the host), or its environment
// lookup S times.  The JAX wave stages an environment escape and resolves
// it in one merged lookup a round later (a device for the TPU's gathers);
// here the escape looks its radiance up at once, the same value added in
// the same order, since an escape is its sample's last term.
//
// The appearance features (environment map, smooth normals, texture:
// none, checker or image; texture.cuh) are template parameters of stages P
// and S, one instantiation a combination, chosen at launch from which
// tables are given: the featureless instantiation is the code without
// them.  Stage S reads the depth-0 vertex, its smooth normal and textured
// albedo among it, from stage P's record.
//
// Design.  A pixel's work ranges from nothing (its primary misses the
// grid) to S * D bounces with their shadow rays, and a warp that serves
// whole pixels executes the union of its lanes' phases: the primary, the
// depth-0 vertex, the bounces, the sample-end restart.  So three kernels:
//   * stage P (gi_primary_kernel), one thread a pixel: the camera ray, the
//     primary march, the depth-0 vertex and its shadow ray, which settles
//     d0.  A pixel that does not hit writes bg_acc; a hit appends its
//     depth-0 record (key0, d0, point, normal, albedo, incident direction,
//     km, pixel) to a compact queue with one warp-aggregated atomicAdd.
//     The record is staged in shared memory across the shadow march, so
//     the lane keeps only its march state in registers.
//   * stage S (gi_sample_kernel), a persistent wave of the blocks that stay
//     resident (SMs x the occupancy calculator's): its warps pop items
//     (queued pixel q, sample s) from an atomic head in warp-local chunks of
//     kChunk (the pool in shared memory), and idle lanes take the next
//     items when half the warp is idle, as kernel E refills.  It reads the
//     queue's length on the device, so the host never waits for it.  Every
//     item runs the same code: a bounce from the depth-0 vertex, then up to
//     D vertices with their NEE shadow rays; it writes v_s to scratch.
//   * the fold (gi_fold_kernel): each queued pixel's rad = ((0 + v_0) +
//     v_1) + ... in sample order, and its capped flag counted once.
// Why the split is exact: given the depth-0 vertex, a pixel's samples are
// independent and all start the same way: sample 0's draws use
// sample_key(key0, 0) with the depth-1 salts, which are a restart's, and
// its throughput 1 * alb0 and starting sum 0 + pend are bitwise a
// restart's alb0 and d0.  Measured on the card (PERF.md) against one
// thread a pixel serving all its samples (about 30% slower) and kernel
// E's persistent wave over whole pixels (slower still); refilling every
// step, chunks of 8 items, a persistent stage P and both stages in one
// persistent kernel (stage S's items taken as their records are flagged)
// measured slower than this.  The tensor cores do not apply (the only
// products are 3x3 determinants), nor does TMA (the reads are scattered
// gathers of grid rows, not tiles).
//
// Exactness against the plain version (ops/gi_wave.gi_wave_plain):
// -fmad=false and no fast math; every expression in the JAX order.  The
// shadow direction divides by the norm; NEE's wl divides by
// sqrt(max(d2, 1e-20)); cos and sin of the sampled angle are taken in
// float64 and rounded to float32, as the plain version takes them
// (libdevice cos/sin on the card, the same functions torch's CUDA cos/sin
// call for float64).  The camera rays equal the CPU batch's bits (camera.cuh).  The
// counters are schedule-free integer sums; `capped` counts a pixel once
// (a flag a queued pixel, set by any of its segments).
//
// Bound on the H100: FP32 operations rather than bytes on the official GI
// frame (chip_smoke.py reports both from the kernel's counters).  The
// kernels stand far from it, bound by instruction issue as C and E are.
// The optional `lanes` counter reports, for stage P and stage S, the warp
// iterations, the lane-steps that marched in them (their ratio over 32 is
// the lane utilisation) and the warp steps in which a lane ended a segment.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "camera.cuh"
#include "hash.cuh"
#include "packed_step.cuh"
#include "texture.cuh"

// The launch's scalars, passed by value from ctypes (the layout of
// ops/gi_wave._GiParams).  m holds the grid, the light and the layout (its
// gate, fused, skip and chain fields are not read: the JAX wave probes one
// cell a step); m.n_rays is the number of pixels.
struct GiParams {
  MarchParams m;
  float li, gate0, gate_b, eps, smint;
  float bg[3], bg_acc[3];
  int quirk, S, D, seg_bound, n_faces, n_mats, has_spec;
};

// The scratch in device memory (laid out by ops/gi_wave._scratch_layout):
// heads[0] counts the queued pixels and heads[1] is stage S's item head,
// both zeroed by the launch; per queued pixel q a capped flag and a
// kRecord-float4 depth-0 record; per item q*S + s its radiance v_s.
struct Queue {
  int* heads;
  int* flags;
  float4* recs;
  float* v;
};

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kMinBlocksP = 6;  // at most 80 registers a thread
constexpr int kMinBlocksS = 8;  // at most 64
constexpr int kChunk = 32;      // items a warp takes from stage S's head at once
constexpr int kRefillAt = 16;   // idle lanes that make a stage-S warp refill
constexpr int kRecord = 5;      // float4s of a depth-0 record
constexpr int kFoldBlock = 256;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTiny = 1e-20f;

enum Event { kPrimaries, kBounces, kShadows, kVertices, kMirrors, kEscapes, kSlotTests };

// Optional counters (null when not wanted), zeroed by the caller.
struct Counters {
  int* capped;                 // pixels a segment of which reached the step bound
  int* passes;                 // tested slots that passed the barycentric test
  unsigned long long* events;  // the seven counts of ops/gi_wave.EVENTS
  unsigned long long* lanes;   // per stage: warp iterations, active lane-steps and
                               // warp steps in which a lane ended a segment
};

__device__ __forceinline__ float tiny_max(float x) { return nan_max(x, kTiny); }

// Duff et al.'s orthonormal basis around n, op for op as pathtrace._onb.
__device__ __forceinline__ void onb(const float n[3], float b1[3], float b2[3]) {
  const float s = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + n[2]);
  const float b = n[0] * n[1] * a;
  b1[0] = 1.0f + s * n[0] * n[0] * a;
  b1[1] = s * b;
  b1[2] = -s * n[0];
  b2[0] = b;
  b2[1] = s + n[1] * n[1] * a;
  b2[2] = -n[1];
}

// pathtrace._cosine_sample: cos and sin in float64, rounded to float32.
__device__ __forceinline__ void cosine_sample(const float n[3], float u1, float u2,
                                              float out[3]) {
  float b1[3], b2[3];
  onb(n, b1, b2);
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float c = (float)cos((double)phi);
  const float sn = (float)sin((double)phi);
  const float x = r * c;
  const float y = r * sn;
  const float z = sqrtf(nan_max(1.0f - u1, 0.0f));
  for (int k = 0; k < 3; ++k) out[k] = (x * b1[k] + y * b2[k]) + z * n[k];
}

// d - (2 * dot(d, n)) * n, unnormalized (the mirror bounce).
__device__ __forceinline__ void mirror(const float d[3], const float n[3], float out[3]) {
  const float two = 2.0f * dot3(d, n);
  for (int k = 0; k < 3; ++k) out[k] = d[k] - two * n[k];
}

// Fold a thread's counters a warp at a time (every lane of the warp calls it).
__device__ void fold_counters(const Counters& C, int capped, const unsigned ev[kSlotTests],
                              unsigned tested, int block_tris) {
  const bool lead = (threadIdx.x & 31) == 0;
  if (C.capped != nullptr) {
    const int c = __reduce_add_sync(kFull, capped);
    if (lead && c != 0) atomicAdd(C.capped, c);
  }
  if (C.events != nullptr) {
    for (int e = 0; e < kSlotTests; ++e) {
      const unsigned c = __reduce_add_sync(kFull, ev[e]);
      if (lead && c != 0) atomicAdd(C.events + e, (unsigned long long)c);
    }
    const unsigned t = __reduce_add_sync(kFull, tested);
    if (lead && t != 0) {
      atomicAdd(C.events + kSlotTests, (unsigned long long)t * (unsigned long long)block_tris);
    }
  }
}

// Add a warp's lane counts to stage `stage`'s (lane 0 of every warp calls it).
__device__ void fold_lanes(const Counters& C, int stage, unsigned long long iters,
                           unsigned long long steps, unsigned long long trans) {
  if (C.lanes != nullptr && (threadIdx.x & 31) == 0 && iters != 0) {
    atomicAdd(C.lanes + 3 * stage, iters);
    atomicAdd(C.lanes + 3 * stage + 1, steps);
    atomicAdd(C.lanes + 3 * stage + 2, trans);
  }
}

// Start a march segment (the JAX loop's rearm).
__device__ __forceinline__ void arm(Lane& L, const float o[3], const float d[3], float t0,
                                    float gate, bool phase) {
  for (int k = 0; k < 3; ++k) {
    L.o[k] = o[k];
    L.d[k] = d[k];
    L.invd[k] = 1.0f / d[k];
  }
  L.t_cur = t0;
  L.gate = gate;
  L.best_t = INFINITY;
  L.best_blk = 0;
  L.best_slot = 0;
  L.cursor = 0;
  L.testing = false;
  L.phase = phase;
  L.alive = true;
}

// Whether the segment in L ended this step: a path segment past
// min(maxt, best_t) between cells, off the grid or capped; a shadow
// segment at its first accepted hit, off the grid or capped.
__device__ __forceinline__ bool segment_ended(const Lane& L, bool timeout) {
  if (!L.phase) {
    const float limit = nan_min(INFINITY, L.best_t);
    return (L.alive && !L.testing && L.t_cur > limit) || !L.alive || timeout;
  }
  return (L.alive && finite(L.best_t)) || !L.alive || timeout;
}

// The vertex of a path segment that retired on a hit: the recomputed-t
// point poi_r for the integrator, the march's point poi_m for the shadow
// ray, the normal n oriented against the ray (the face's, or its corner
// normals interpolated), the albedo (the material's row, or the textured
// raw base color clipped), direct = albedo/pi * I*cos/d^2 (the NEE term
// before the throughput), cos_i, and the material's km (0 without the
// mirror mix).
template <bool kSmooth, int kTex>
__device__ void resolve_vertex(const GiParams& G, const AppearParams& AP, const Lane& L,
                               const int* slot_tri, const float* tri9, const float* albedo,
                               const float* km_tab, float poi_r[3], float poi_m[3], float n[3],
                               float alb[3], float direct[3], float& cos_i, float& km) {
  const MarchParams& P = G.m;
  const int slot = clampi(L.best_blk * P.block_tris + L.best_slot, 0, P.n_slots - 1);
  const int tri = clampi(slot_tri[slot], 0, G.n_faces - 1);
  const float* row = tri9 + (size_t)tri * 10;
  const float* v0 = row;
  const float* v1 = row + 3;
  const float* v2 = row + 6;
  const int mat = clampi((int)row[9], 0, G.n_mats - 1);
  // cramer_t_safe on a valid lane: tn / A, or 0 where A == 0
  float e1[3], e2[3], sc[3];
  for (int k = 0; k < 3; ++k) {
    e1[k] = v0[k] - v1[k];
    e2[k] = v0[k] - v2[k];
    sc[k] = v0[k] - L.o[k];
  }
  const float A = det3(e1[0], e2[0], L.d[0], e1[1], e2[1], L.d[1], e1[2], e2[2], L.d[2]);
  const float tn = det3(e1[0], e2[0], sc[0], e1[1], e2[1], sc[1], e1[2], e2[2], sc[2]);
  const bool guard = A != 0.0f;
  const float t_r = (guard ? tn : 0.0f) / (guard ? A : 1.0f);
  float a[3], b[3], cr[3], gn[3], to_l[3], wl[3];
  for (int k = 0; k < 3; ++k) {
    poi_r[k] = L.o[k] + L.d[k] * t_r;
    poi_m[k] = L.o[k] + L.d[k] * L.best_t;
    a[k] = v1[k] - v0[k];
    b[k] = v2[k] - v0[k];
  }
  cross3(a, b, cr);
  normalize3(cr, gn);
  float hb = 0.0f, hg = 0.0f, alpha = 0.0f;
  if constexpr (kSmooth || kTex != kTexNone) {
    // cramer_bg_safe on a valid lane: the numerators over A, or 0 where A == 0
    const float bn = det3(sc[0], e2[0], L.d[0], sc[1], e2[1], L.d[1], sc[2], e2[2], L.d[2]);
    const float gm = det3(e1[0], sc[0], L.d[0], e1[1], sc[1], L.d[1], e1[2], sc[2], L.d[2]);
    hb = (guard ? bn : 0.0f) / (guard ? A : 1.0f);
    hg = (guard ? gm : 0.0f) / (guard ? A : 1.0f);
    alpha = 1.0f - hb - hg;
  }
  if constexpr (kSmooth) {
    const float* c = AP.fvn9 + (size_t)tri * 9;
    float sn[3], un[3];
    for (int k = 0; k < 3; ++k) {
      sn[k] = alpha * __ldg(c + k) + hb * __ldg(c + 3 + k) + hg * __ldg(c + 6 + k);
    }
    normalize3(sn, un);
    normalize3(un, gn);
  }
  const bool flip = dot3(gn, L.d) > 0.0f;
  for (int k = 0; k < 3; ++k) {
    n[k] = flip ? -gn[k] : gn[k];
    to_l[k] = P.light[k] - poi_r[k];
  }
  const float d2 = dot3(to_l, to_l);
  const float den = sqrtf(tiny_max(d2));
  for (int k = 0; k < 3; ++k) wl[k] = to_l[k] / den;
  cos_i = nan_max(dot3(n, wl), 0.0f);
  const float q = G.li * cos_i / tiny_max(d2);
  if constexpr (kTex != kTexNone) {
    const float* u = AP.fuv7 + (size_t)tri * 7;
    float uv[2], f[3];
    for (int k = 0; k < 2; ++k) {
      uv[k] = alpha * __ldg(u + k) + hb * __ldg(u + 2 + k) + hg * __ldg(u + 4 + k);
    }
    texture_factor<kTex>(AP, uv, __ldg(u + 6) > 0.5f, f);
    for (int c = 0; c < 3; ++c) {
      alb[c] = nan_min(nan_max(__ldg(AP.bc255 + 3 * mat + c) * f[c], 0.0f), 1.0f);
    }
  } else {
    for (int c = 0; c < 3; ++c) alb[c] = albedo[3 * mat + c];
  }
  for (int c = 0; c < 3; ++c) direct[c] = alb[c] * kInvPi * q;
  km = G.has_spec ? km_tab[mat] : 0.0f;
}

// The NEE shadow ray from the march's point: a divide by the norm, and its
// slab entry.
__device__ __forceinline__ void shadow_ray(const GiParams& G, const float poi_m[3],
                                           float sdir[3], float& st0, bool& entered) {
  float to_lm[3];
  for (int k = 0; k < 3; ++k) to_lm[k] = G.m.light[k] - poi_m[k];
  const float norm = sqrtf(dot3(to_lm, to_lm));
  const float nden = norm > 0.0f ? norm : 1.0f;
  for (int k = 0; k < 3; ++k) {
    sdir[k] = to_lm[k] / nden;
    if (G.quirk) sdir[k] = -sdir[k];  // Serial/raytracer.cpp:106
  }
  slab_entry(G.m, poi_m, sdir, G.smint, INFINITY, st0, entered);
}

// The radiance an escape in direction dir sees: the environment map by the
// normalized direction, or the flat background.
template <bool kEnv>
__device__ __forceinline__ void escape(const GiParams& G, const AppearParams& AP,
                                       const float dir[3], float out[3]) {
  if constexpr (kEnv) {
    sample_env(AP, dir, out);
  } else {
    for (int c = 0; c < 3; ++c) out[c] = G.bg[c];
  }
}

// A pixel whose primary misses: every sample sees the same escape, summed S
// times from 0 (bg_acc, made on the host, for the flat background).
template <bool kEnv>
__device__ __forceinline__ void write_miss(const GiParams& G, const AppearParams& AP,
                                           const float dir[3], float* rad_out, int pixel) {
  if constexpr (kEnv) {
    float e[3];
    sample_env(AP, dir, e);
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
      for (int s = 0; s < G.S; ++s) acc = acc + e[c];
      rad_out[3 * pixel + c] = acc;
    }
  } else {
    for (int c = 0; c < 3; ++c) rad_out[3 * pixel + c] = G.bg_acc[c];
  }
}

// The bounce direction of a vertex at depth saltd - 1: the mirror of idir
// about n on a mirror draw, else a cosine-weighted draw around n from the
// sample key.
__device__ __forceinline__ void bounce_dir(uint32_t key, uint32_t saltd, const float n[3],
                                           const float idir[3], bool spec, float out[3]) {
  if (spec) {
    mirror(idir, n, out);
    return;
  }
  const float u1 = hash_u01(key, 0x1000193u * saltd);
  const float u2 = hash_u01(key, 0x5BD1E995u * saltd + 7u);
  cosine_sample(n, u1, u2, out);
}

// A thread's event counts in shared memory, one column a thread of the
// block's (kSlotTests, kBlock) table.
struct Tally {
  unsigned* col;
  __device__ __forceinline__ void add(int e, unsigned k) const { col[e * kBlock] += k; }
};

// A stage-P lane: one pixel's primary and depth-0 shadow segments.  The
// depth-0 record is staged in shared memory (kStage floats a thread).
struct Prim {
  Lane L;
  int lsteps;
  uint32_t key0;
  bool capped;
};

// Shared staging slots of stage P: poi0 (0-2), n0 (3-5), alb0 (6-8), idir0
// (9-11), km0 (12), pend and then d0 (13-15).
constexpr int kStage = 16;

enum Step { kGoOn, kDone, kQueue };

// Stage P's transition of a lane that ran this step: kDone when the primary
// missed (its escape written), kQueue when d0 is settled and staged.
template <bool kEnv, bool kSmooth, int kTex>
__device__ int primary_transition(const GiParams& G, const AppearParams& AP, Prim& S,
                                  const int* slot_tri, const float* tri9, const float* albedo,
                                  const float* km_tab, float* stage, const Tally& ev,
                                  float* rad_out, int pixel, bool& ran) {
  Lane& L = S.L;
  const bool hit_now = finite(L.best_t);
  const bool timeout = L.alive && S.lsteps > G.seg_bound;
  S.capped = S.capped || timeout;
  if (!segment_ended(L, timeout)) return kGoOn;
  ran = true;
  if (L.phase) {  // the depth-0 shadow ray: settle d0
    for (int c = 0; c < 3; ++c) {
      stage[(13 + c) * kBlock] = 0.0f + (!hit_now ? stage[(13 + c) * kBlock] : 0.0f);
    }
    return kQueue;
  }
  if (!hit_now) {  // the primary missed: every sample sees its escape
    write_miss<kEnv>(G, AP, L.d, rad_out, pixel);
    return kDone;
  }
  ev.add(kVertices, 1);
  float poi_r[3], poi_m[3], n[3], alb[3], direct[3], cos_i, km;
  resolve_vertex<kSmooth, kTex>(G, AP, L, slot_tri, tri9, albedo, km_tab, poi_r, poi_m, n, alb,
                                direct, cos_i, km);
  for (int k = 0; k < 3; ++k) {
    stage[k * kBlock] = poi_r[k];
    stage[(3 + k) * kBlock] = n[k];
    stage[(6 + k) * kBlock] = alb[k];
    stage[(9 + k) * kBlock] = L.d[k];
  }
  stage[12 * kBlock] = km;
  float sdir[3], st0;
  bool s_entered;
  shadow_ray(G, poi_m, sdir, st0, s_entered);
  if (cos_i > 0.0f && s_entered) {  // the throughput is 1 at depth 0
    for (int c = 0; c < 3; ++c) stage[(13 + c) * kBlock] = direct[c];
    arm(L, poi_m, sdir, st0, G.eps, true);
    S.lsteps = 0;
    ev.add(kShadows, 1);
    return kGoOn;
  }
  for (int c = 0; c < 3; ++c) stage[(13 + c) * kBlock] = direct[c] + 0.0f;
  return kQueue;
}

// Take pixel `pixel`: its camera ray, key and slab entry.  Returns whether
// the primary entered the grid; else the pixel's radiance is its escape's.
template <bool kEnv>
__device__ __forceinline__ bool start_primary(const GiParams& G, const AppearParams& AP,
                                              const CameraParams& CP, const float4* subs,
                                              int pixel, Prim& S, float* rad_out,
                                              const Tally& ev) {
  Lane& L = S.L;
  camera_ray_at(CP, subs, pixel, L.o, L.d);
  float t0;
  bool entered;
  slab_entry(G.m, L.o, L.d, 0.0f, INFINITY, t0, entered);
  if (!entered) {
    write_miss<kEnv>(G, AP, L.d, rad_out, pixel);
    return false;
  }
  S.key0 = ray_sample_key(L.o, L.d);
  arm(L, L.o, L.d, t0, G.gate0, false);
  L.t_exit_cell = 0.0f;
  L.first_blk = L.n_blk = 0;
  S.lsteps = 0;
  S.capped = false;
  ev.add(kPrimaries, 1);
  return true;
}

// Append the warp's lanes with enq set to the queue with one atomicAdd and
// write their depth-0 records from the staging slots (every lane calls it).
__device__ __forceinline__ void enqueue(const Queue& Q, bool enq, const Prim& S,
                                        const float* stage, int pixel) {
  const int lane = threadIdx.x & 31;
  const unsigned qm = __ballot_sync(kFull, enq);
  if (qm == 0u) return;
  const int leader = __ffs(qm) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(Q.heads, __popc(qm));
  base = __shfl_sync(kFull, base, leader);
  if (!enq) return;
  const int q = base + __popc(qm & ((1u << lane) - 1u));
  float4* rec = Q.recs + (size_t)q * kRecord;
  rec[0] = make_float4(stage[0], stage[kBlock], stage[2 * kBlock], __uint_as_float(S.key0));
  rec[1] = make_float4(stage[3 * kBlock], stage[4 * kBlock], stage[5 * kBlock],
                       stage[12 * kBlock]);
  rec[2] = make_float4(stage[6 * kBlock], stage[7 * kBlock], stage[8 * kBlock],
                       __int_as_float(pixel));
  rec[3] = make_float4(stage[9 * kBlock], stage[10 * kBlock], stage[11 * kBlock], 0.0f);
  rec[4] = make_float4(stage[13 * kBlock], stage[14 * kBlock], stage[15 * kBlock], 0.0f);
  Q.flags[q] = S.capped ? 1 : 0;
}

// Stage P: one thread a pixel.  A hit's depth-0 record goes to the queue.
template <bool kEnv, bool kSmooth, int kTex>
__global__ void __launch_bounds__(kBlock, kMinBlocksP)
gi_primary_kernel(GiParams G, AppearParams AP, CameraParams CP, const float4* __restrict__ subs,
                  const int* __restrict__ cell_info, const float* __restrict__ blocks,
                  const int* __restrict__ slot_tri, const float* __restrict__ tri9,
                  const float* __restrict__ albedo, const float* __restrict__ km_tab,
                  float* __restrict__ rad_out, Queue Q, Counters C) {
  __shared__ float s_stage[kStage * kBlock];
  __shared__ unsigned s_ev[kSlotTests * kBlock];
  const MarchParams& P = G.m;
  const int pixel = blockIdx.x * kBlock + threadIdx.x;
  float* stage = s_stage + threadIdx.x;
  const Tally ev{s_ev + threadIdx.x};
  for (int e = 0; e < kSlotTests; ++e) ev.col[e * kBlock] = 0u;
  Prim S;
  Lane& L = S.L;
  bool active =
      pixel < P.n_rays && start_primary<kEnv>(G, AP, CP, subs, pixel, S, rad_out, ev);
  int capped = 0;
  unsigned tested = 0;
  unsigned long long iters = 0, steps = 0, trans = 0;
  for (;;) {
    const unsigned marching = __ballot_sync(kFull, active);
    if (marching == 0u) break;
    ++iters;
    steps += __popc(marching);
    const int blk = active ? step_fetch(P, L, cell_info, blocks, nullptr) : -1;
    float m;
    int slot;
    rows_min_warp(P, blocks, blk, L, INFINITY, C.passes, m, slot);
    bool ran = false, enq = false;
    if (active) {
      int t = 0;
      step_finish(P, L, blk, m, slot, cell_info, blocks, nullptr, t);
      tested += t;
      ++S.lsteps;
      const int r = primary_transition<kEnv, kSmooth, kTex>(
          G, AP, S, slot_tri, tri9, albedo, km_tab, stage, ev, rad_out, pixel, ran);
      if (r != kGoOn) {
        active = false;
        enq = r == kQueue;
        if (r == kDone) capped += S.capped ? 1 : 0;
      }
    }
    if (C.lanes != nullptr && __ballot_sync(kFull, ran) != 0u) ++trans;
    enqueue(Q, enq, S, stage, pixel);
  }
  unsigned evr[kSlotTests];
  for (int e = 0; e < kSlotTests; ++e) evr[e] = ev.col[e * kBlock];
  fold_counters(C, capped, evr, tested, P.block_tris);
  fold_lanes(C, 0, iters, steps, trans);
}

// A stage-S lane: one item (queued pixel q, sample s) from its first
// bounce to its end.  w is the throughput on a path segment and the next
// bounce's throughput across a shadow segment; the vertex staged across a
// shadow segment (pend, n, point) is in shared memory.
struct Item {
  Lane L;
  int lsteps, depth, idx;
  uint32_t key;
  float vcur[3], w[3];
  bool capped;
};

// Shared staging slots of stage S: pend (0-2), n (3-5), the vertex point (6-8).
constexpr int kItemStage = 9;

// Write item idx's radiance; a capped item flags its pixel.
__device__ __forceinline__ void finish_item(const GiParams& G, const Queue& Q, int idx,
                                            const float v[3], bool capped) {
  float* out = Q.v + (size_t)idx * 3;
  for (int c = 0; c < 3; ++c) out[c] = v[c];
  if (capped) Q.flags[idx / G.S] = 1;
}

// Take item idx: its sample's branch draw and first bounce from the
// depth-0 record.  Returns whether the bounce entered the grid; else the
// item is done (its radiance written).
template <bool kEnv>
__device__ bool start_item(const GiParams& G, const AppearParams& AP, const Queue& Q, int idx,
                           Item& I, const Tally& ev) {
  const int q = idx / G.S;
  const int s = idx - q * G.S;
  const float4* rec = Q.recs + (size_t)q * kRecord;
  const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2], r4 = rec[4];
  const uint32_t key = sample_key(__float_as_uint(r0.w), s);
  bool spec = false;
  if (G.has_spec) {
    spec = hash_u01(key, 0x85EBCA77u + 13u) < r1.w;
    ev.add(kMirrors, spec ? 1u : 0u);
  }
  const float d0[3] = {r4.x, r4.y, r4.z};
  float v[3];
  for (int c = 0; c < 3; ++c) v[c] = spec ? 0.0f : d0[c];
  if (G.D == 0) {  // v_s is d0 for a diffuse draw, 0 for a mirror draw
    finish_item(G, Q, idx, v, false);
    return false;
  }
  const float poi0[3] = {r0.x, r0.y, r0.z};
  const float n0[3] = {r1.x, r1.y, r1.z};
  const float alb0[3] = {r2.x, r2.y, r2.z};
  float idir0[3] = {0.0f, 0.0f, 0.0f};
  if (spec) {
    const float4 r3 = rec[3];
    idir0[0] = r3.x;
    idir0[1] = r3.y;
    idir0[2] = r3.z;
  }
  float ndir[3], tpt[3];
  bounce_dir(key, 1u, n0, idir0, spec, ndir);
  for (int c = 0; c < 3; ++c) tpt[c] = spec ? 1.0f : alb0[c];
  float st;
  bool ent;
  slab_entry(G.m, poi0, ndir, G.eps, INFINITY, st, ent);
  if (!ent) {
    ev.add(kEscapes, 1);
    float e[3];
    escape<kEnv>(G, AP, ndir, e);
    for (int c = 0; c < 3; ++c) v[c] = v[c] + tpt[c] * e[c];
    finish_item(G, Q, idx, v, false);
    return false;
  }
  arm(I.L, poi0, ndir, st, G.gate_b, false);
  I.lsteps = 0;
  I.depth = 1;
  I.idx = idx;
  I.key = key;
  I.capped = false;
  for (int c = 0; c < 3; ++c) {
    I.vcur[c] = v[c];
    I.w[c] = tpt[c];
  }
  ev.add(kBounces, 1);
  return true;
}

// Stage S's transition of a lane that ran this step (every vertex is at
// depth 1 or more).  Returns true when the item is done.
template <bool kEnv, bool kSmooth, int kTex>
__device__ bool item_transition(const GiParams& G, const AppearParams& AP, const Queue& Q,
                                Item& I, const int* slot_tri, const float* tri9,
                                const float* albedo, const float* km_tab, float* stage,
                                const Tally& ev, bool& ran) {
  Lane& L = I.L;
  const bool hit_now = finite(L.best_t);
  const bool timeout = L.alive && I.lsteps > G.seg_bound;
  I.capped = I.capped || timeout;
  if (!segment_ended(L, timeout)) return false;
  ran = true;
  const int depth_v = I.depth;
  float nrm[3], vpos[3], idir[3], w[3];
  bool spec = false;
  if (L.phase) {  // settle the staged NEE (a vertex that shadows is diffuse)
    for (int c = 0; c < 3; ++c) {
      I.vcur[c] = I.vcur[c] + (!hit_now ? stage[c * kBlock] : 0.0f);
      nrm[c] = stage[(3 + c) * kBlock];
      vpos[c] = stage[(6 + c) * kBlock];
      idir[c] = 0.0f;
      w[c] = I.w[c];
    }
  } else if (!hit_now) {  // the bounce missed: its escape
    ev.add(kEscapes, 1);
    float e[3];
    escape<kEnv>(G, AP, L.d, e);
    for (int c = 0; c < 3; ++c) I.vcur[c] = I.vcur[c] + I.w[c] * e[c];
    finish_item(G, Q, I.idx, I.vcur, I.capped);
    return true;
  } else {  // resolve the vertex
    ev.add(kVertices, 1);
    float poi_m[3], alb[3], direct[3], cos_i, km;
    resolve_vertex<kSmooth, kTex>(G, AP, L, slot_tri, tri9, albedo, km_tab, vpos, poi_m, nrm,
                                  alb, direct, cos_i, km);
    if (G.has_spec) {
      const float u3 = hash_u01(I.key, 0x85EBCA77u * (uint32_t)(depth_v + 1) + 13u);
      spec = u3 < km;
      ev.add(kMirrors, spec ? 1u : 0u);
    }
    float pend[3];
    for (int c = 0; c < 3; ++c) {
      pend[c] = I.w[c] * direct[c];
      w[c] = I.w[c] * (spec ? 1.0f : alb[c]);
      idir[c] = L.d[c];
    }
    float sdir[3], st0;
    bool s_entered;
    shadow_ray(G, poi_m, sdir, st0, s_entered);
    if (cos_i > 0.0f && !spec && s_entered) {
      for (int c = 0; c < 3; ++c) {
        stage[c * kBlock] = pend[c];
        stage[(3 + c) * kBlock] = nrm[c];
        stage[(6 + c) * kBlock] = vpos[c];
        I.w[c] = w[c];
      }
      arm(L, poi_m, sdir, st0, G.eps, true);
      I.lsteps = 0;
      ev.add(kShadows, 1);
      return false;
    }
    for (int c = 0; c < 3; ++c) I.vcur[c] = I.vcur[c] + (!spec ? pend[c] : 0.0f);
  }
  if (depth_v < G.D) {  // the bounce
    float ndir[3];
    bounce_dir(I.key, (uint32_t)(depth_v + 1), nrm, idir, spec, ndir);
    float stb;
    bool entb;
    slab_entry(G.m, vpos, ndir, G.eps, INFINITY, stb, entb);
    if (entb) {
      arm(L, vpos, ndir, stb, G.gate_b, false);
      I.lsteps = 0;
      I.depth = depth_v + 1;
      for (int c = 0; c < 3; ++c) I.w[c] = w[c];
      ev.add(kBounces, 1);
      return false;
    }
    ev.add(kEscapes, 1);  // the bounce misses the grid
    float e[3];
    escape<kEnv>(G, AP, ndir, e);
    for (int c = 0; c < 3; ++c) I.vcur[c] = I.vcur[c] + w[c] * e[c];
  }
  finish_item(G, Q, I.idx, I.vcur, I.capped);
  return true;
}

// Stage S: a persistent wave over the queue's items (q * S + s); idle lanes
// take the next items of a warp-local chunk when kRefillAt lanes or more
// are idle, until the queue is drained.
template <bool kEnv, bool kSmooth, int kTex>
__global__ void __launch_bounds__(kBlock, kMinBlocksS)
gi_sample_kernel(GiParams G, AppearParams AP, const int* __restrict__ cell_info,
                 const float* __restrict__ blocks,
                 const int* __restrict__ slot_tri, const float* __restrict__ tri9,
                 const float* __restrict__ albedo, const float* __restrict__ km_tab, Queue Q,
                 Counters C) {
  __shared__ float s_stage[kItemStage * kBlock];
  __shared__ unsigned s_ev[kSlotTests * kBlock];
  __shared__ int s_pool[kWarps][2];  // the warp's unserved items [pool, end)
  const MarchParams& P = G.m;
  const int n = Q.heads[0] * G.S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  float* stage = s_stage + threadIdx.x;
  const Tally ev{s_ev + threadIdx.x};
  for (int e = 0; e < kSlotTests; ++e) ev.col[e * kBlock] = 0u;
  if (lane == 0) s_pool[warp][0] = s_pool[warp][1] = 0;
  __syncwarp();
  Item I;
  I.L.t_exit_cell = 0.0f;
  I.L.first_blk = I.L.n_blk = 0;
  bool active = false;
  bool drained = false;
  unsigned tested = 0;
  unsigned long long iters = 0, steps = 0, trans = 0;
  for (;;) {
    while (!drained) {
      const unsigned idle = __ballot_sync(kFull, !active);
      if (idle != kFull && __popc(idle) < kRefillAt) break;
      int pool = s_pool[warp][0], end = s_pool[warp][1];
      if (pool >= end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(Q.heads + 1, kChunk);
        base = __shfl_sync(kFull, base, 0);
        if (base >= n) {
          drained = true;
          break;
        }
        pool = base;
        end = base + kChunk < n ? base + kChunk : n;
      }
      const int rank = __popc(idle & below);
      if (!active && rank < end - pool) active = start_item<kEnv>(G, AP, Q, pool + rank, I, ev);
      const int took = __popc(idle) < end - pool ? __popc(idle) : end - pool;
      __syncwarp();
      if (lane == 0) {
        s_pool[warp][0] = pool + took;
        s_pool[warp][1] = end;
      }
      __syncwarp();
    }
    const unsigned marching = __ballot_sync(kFull, active);
    if (marching == 0u) break;
    ++iters;
    steps += __popc(marching);
    const int blk = active ? step_fetch(P, I.L, cell_info, blocks, nullptr) : -1;
    float m;
    int slot;
    rows_min_warp(P, blocks, blk, I.L, INFINITY, C.passes, m, slot);
    bool ran = false;
    if (active) {
      int t = 0;
      step_finish(P, I.L, blk, m, slot, cell_info, blocks, nullptr, t);
      tested += t;
      ++I.lsteps;
      if (item_transition<kEnv, kSmooth, kTex>(G, AP, Q, I, slot_tri, tri9, albedo, km_tab,
                                               stage, ev, ran)) {
        active = false;
      }
    }
    if (C.lanes != nullptr && __ballot_sync(kFull, ran) != 0u) ++trans;
  }
  unsigned evr[kSlotTests];
  for (int e = 0; e < kSlotTests; ++e) evr[e] = ev.col[e * kBlock];
  fold_counters(C, 0, evr, tested, P.block_tris);
  fold_lanes(C, 1, iters, steps, trans);
}

// The fold: each queued pixel's radiance ((0 + v_0) + v_1) + ... in sample
// order, and its capped flag counted once.
__global__ void __launch_bounds__(kFoldBlock)
gi_fold_kernel(int S, Queue Q, float* __restrict__ rad_out, int* __restrict__ capped_out) {
  const int nq = Q.heads[0];
  int capped = 0;
  for (int q = blockIdx.x * kFoldBlock + threadIdx.x; q < nq; q += gridDim.x * kFoldBlock) {
    const int pixel = __float_as_int(Q.recs[(size_t)q * kRecord + 2].w);
    const float* v = Q.v + (size_t)q * S * 3;
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    for (int s = 0; s < S; ++s) {
      r0 = r0 + v[3 * s];
      r1 = r1 + v[3 * s + 1];
      r2 = r2 + v[3 * s + 2];
    }
    rad_out[3 * pixel] = r0;
    rad_out[3 * pixel + 1] = r1;
    rad_out[3 * pixel + 2] = r2;
    capped += Q.flags[q] != 0 ? 1 : 0;
  }
  if (capped_out != nullptr) {
    const int c = __reduce_add_sync(kFull, capped);
    if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(capped_out, c);
  }
}

// Stages P and S of one feature combination.
template <bool kEnv, bool kSmooth, int kTex>
cudaError_t launch_stages(const GiParams& G, const AppearParams& AP, const CameraParams& CP,
                          const float* subs, const int* cell_info, const float* blocks,
                          const int* slot_tri, const float* tri9, const float* albedo,
                          const float* km, float* rad, const Queue& Q, const Counters& C,
                          int grid_p, int grid_s, cudaStream_t st) {
  gi_primary_kernel<kEnv, kSmooth, kTex><<<(unsigned)grid_p, kBlock, 0, st>>>(
      G, AP, CP, reinterpret_cast<const float4*>(subs), cell_info, blocks, slot_tri, tri9,
      albedo, km, rad, Q, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gi_sample_kernel<kEnv, kSmooth, kTex><<<(unsigned)grid_s, kBlock, 0, st>>>(
      G, AP, cell_info, blocks, slot_tri, tri9, albedo, km, Q, C);
  return cudaGetLastError();
}

// The instantiation that AP's tables select: the environment map, smooth
// normals, and no texture, the checker or the image.
template <bool kEnv, bool kSmooth>
cudaError_t launch_textured(const GiParams& G, const AppearParams& AP, const CameraParams& CP,
                            const float* subs, const int* cell_info, const float* blocks,
                            const int* slot_tri, const float* tri9, const float* albedo,
                            const float* km, float* rad, const Queue& Q, const Counters& C,
                            int grid_p, int grid_s, cudaStream_t st) {
  if (AP.fuv7 == nullptr) {
    return launch_stages<kEnv, kSmooth, kTexNone>(G, AP, CP, subs, cell_info, blocks, slot_tri,
                                                  tri9, albedo, km, rad, Q, C, grid_p, grid_s,
                                                  st);
  }
  if (AP.tex == nullptr) {
    return launch_stages<kEnv, kSmooth, kTexChecker>(G, AP, CP, subs, cell_info, blocks,
                                                     slot_tri, tri9, albedo, km, rad, Q, C,
                                                     grid_p, grid_s, st);
  }
  return launch_stages<kEnv, kSmooth, kTexImage>(G, AP, CP, subs, cell_info, blocks, slot_tri,
                                                 tri9, albedo, km, rad, Q, C, grid_p, grid_s,
                                                 st);
}

}  // namespace

// The SMs, and the blocks of stage S that stay resident on an SM (the
// featureless instantiation's; every instantiation has the same launch
// bounds).  Returns the first CUDA error.
extern "C" int gi_wave_occupancy(int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, gi_sample_kernel<false, false, kTexNone>, kBlock, 0);
  }
  return (int)err;
}

// Launch kernel F over the n_rays = G.m.n_rays pixels of camera CP: subs
// (1, 4) f32 [ox, oy, lx, ly]; cell_info (n_cells,) or (1,) i32, blocks
// (n_blocks, row_lanes) f32, slot_tri (n_slots,) i32, tri9 (n_faces, 10)
// f32, albedo (n_mats, 3) f32, km (n_mats,) f32 or null (no mirror mix);
// AP the appearance tables (null ones off; a texture needs fuv7 and bc255);
// rad (n_rays, 3) f32 out, every row written.  heads, flags, recs and v are
// the scratch of ops/gi_wave._scratch_layout (heads zeroed here); grid_p,
// grid_s and grid_fold the stages' blocks (ops/gi_wave._stage_launch).  The
// counters are null when not wanted, else zeroed by the caller; lanes is
// (2, 3).  Returns the first CUDA error.
extern "C" int gi_wave_launch(GiParams G, CameraParams CP, AppearParams AP, const float* subs,
                              const int* cell_info, const float* blocks, const int* slot_tri,
                              const float* tri9, const float* albedo, const float* km,
                              float* rad, int* heads, int* flags, float* recs, float* v,
                              int grid_p, int grid_s, int grid_fold, int* capped, int* passes,
                              unsigned long long* events, unsigned long long* lanes,
                              void* stream) {
  if (G.has_spec && km == nullptr) return (int)cudaErrorInvalidValue;
  if ((AP.fuv7 == nullptr) != (AP.bc255 == nullptr)) return (int)cudaErrorInvalidValue;
  if (AP.env != nullptr && (AP.env_h < 1 || AP.env_w < 1)) return (int)cudaErrorInvalidValue;
  if (AP.tex != nullptr && (AP.tex_h < 1 || AP.tex_w < 1)) return (int)cudaErrorInvalidValue;
  if (G.m.n_rays == 0) return 0;
  const Counters C{capped, passes, events, lanes};
  const Queue Q{heads, flags, reinterpret_cast<float4*>(recs), v};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(heads, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const bool env = AP.env != nullptr, smooth = AP.fvn9 != nullptr;
  if (env && smooth) {
    err = launch_textured<true, true>(G, AP, CP, subs, cell_info, blocks, slot_tri, tri9, albedo,
                                      km, rad, Q, C, grid_p, grid_s, st);
  } else if (env) {
    err = launch_textured<true, false>(G, AP, CP, subs, cell_info, blocks, slot_tri, tri9,
                                       albedo, km, rad, Q, C, grid_p, grid_s, st);
  } else if (smooth) {
    err = launch_textured<false, true>(G, AP, CP, subs, cell_info, blocks, slot_tri, tri9,
                                       albedo, km, rad, Q, C, grid_p, grid_s, st);
  } else {
    err = launch_textured<false, false>(G, AP, CP, subs, cell_info, blocks, slot_tri, tri9,
                                        albedo, km, rad, Q, C, grid_p, grid_s, st);
  }
  if (err != cudaSuccess) return (int)err;
  gi_fold_kernel<<<(unsigned)grid_fold, kFoldBlock, 0, st>>>(G.S, Q, rad, capped);
  return (int)cudaGetLastError();
}
