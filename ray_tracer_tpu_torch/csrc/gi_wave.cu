// Kernel F: the cross-depth GI wave, one thread a pixel serving the
// pixel's whole path-traced estimate.
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
// Per pixel: its camera ray from its index (camera.cuh's camera_ray_at,
// the JAX wave's refill source), the slab entry, then march steps through
// packed_step.cuh and, after every step, the JAX loop's transition
// (gi_wave.py:345-743, without its environment, texture and smooth-normal
// branches):
//   * a path segment retires when it walks past min(maxt, best_t) between
//     cells, walks off the grid, or has stepped more than seg_bound times.
//     On a hit the vertex resolves through slot_tri and its (F, 10)
//     triangle row: t recomputed (cramer_t_safe) for the integrator's
//     point, the face normal oriented against the ray, the albedo row, the
//     NEE term tpt * albedo/pi * I*cos/d^2 and, with the mirror mix, the
//     branch draw u3 < km.  A diffuse vertex with cos > 0 (and any vertex
//     at depth 0, whose NEE settles d0, shared by every sample) rearms as
//     its NEE shadow ray from the march's own hit point; else its NEE is
//     banked at once.  On a miss a bounce's radiance takes the background.
//   * a shadow segment retires at its first accepted hit, off the grid or
//     at the step bound, and banks its staged NEE when unoccluded.
//   * a vertex below depth D bounces: a cosine-weighted direction (or the
//     mirror direction) from the hash of (pixel, sample, depth); a bounce
//     that misses the grid takes the background at once.
//   * at the end of a sample (depth D reached or an escape) the sample's
//     radiance joins the pixel's sum and the next sample restarts from the
//     shared depth-0 vertex with its own draws (salts 0x1000193,
//     0x5BD1E995 + 7 and, for the branch, 0x85EBCA77 + 13), until S
//     samples are summed.
// Contribution order is the JAX wave's: rad = ((v_0 + v_1) + ...), each
// v_s built escape/NEE-in-depth-order; a pixel whose primary misses sums
// the background S times (bg_acc, made on the host).
//
// Design.  The simple schedule: one thread a pixel, no queue and no
// refill (kernel E measured its half-warp refill at about 2% over that,
// PERF.md).  A warp loops until all its lanes' pixels are done; idle lanes
// still join every step, because the warp deals out the slots of every
// row its lanes test (packed_step.cuh rows_min_warp).  A lane holds its
// march state (packed_step.cuh's Lane, one definition with C and E), the
// current vertex and the shared depth-0 vertex.  The counters are
// schedule-free integer sums.
//
// Exactness against the plain version (ops/gi_wave.gi_wave_plain):
// -fmad=false and no fast math; every expression in the JAX order.  The
// shadow direction divides by the norm; NEE's wl divides by
// sqrt(max(d2, 1e-20)); cos and sin of the sampled angle are taken in
// float64 and rounded to float32, as the plain version takes them (libdevice
// cos/sin on the card, the same functions torch's CUDA cos/sin call for
// float64).  The camera rays equal the CPU batch's bits (camera.cuh).
//
// Bound on the H100: FP32 operations rather than bytes on the official GI
// frame (chip_smoke.py reports both from the kernel's counters: slots
// tested and barycentric passes, vertices, bounces and escapes).  The
// kernel stands far above it (PERF.md): a warp executes the union of its
// lanes' phases, and the simple schedule keeps a warp until its last
// pixel is done.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "camera.cuh"
#include "hash.cuh"
#include "packed_step.cuh"

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

namespace {

constexpr int kBlock = 128;
constexpr int kEvents = 7;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTiny = 1e-20f;

enum Event { kPrimaries, kBounces, kShadows, kVertices, kMirrors, kEscapes, kSlotTests };

// Optional counters (null when not wanted), zeroed by the caller.
struct Counters {
  int* capped;                 // pixels a segment of which reached the step bound
  int* passes;                 // tested slots that passed the barycentric test
  unsigned long long* events;  // the kEvents counts (ops/gi_wave.EVENTS)
};

// A lane's pixel: its march state, the current and the depth-0 vertex, and
// the sums.
struct Path {
  Lane L;
  float maxt_seg;
  int lsteps, depth, samp, tested;
  uint32_t key0;
  float rad[3], vcur[3], tpt[3], pend[3];
  float nrm[3], alb[3], vpos[3], idir[3], vkm;
  bool vspec, capped;
  float d0[3], poi0[3], n0[3], alb0[3], idir0[3], km0;
};

__device__ __forceinline__ float tiny_max(float x) { return nan_max(x, kTiny); }

// Start a segment in place (the JAX loop's rearm; tpt and depth are the
// caller's).
__device__ __forceinline__ void rearm(Path& S, const float o[3], const float d[3], float t0,
                                      float gate, bool phase) {
  Lane& L = S.L;
  for (int k = 0; k < 3; ++k) {
    L.o[k] = o[k];
    L.d[k] = d[k];
    L.invd[k] = 1.0f / d[k];
  }
  L.t_cur = t0;
  L.gate = gate;
  S.maxt_seg = INFINITY;
  L.best_t = INFINITY;
  L.best_blk = 0;
  L.best_slot = 0;
  L.cursor = 0;
  L.testing = false;
  L.phase = phase;
  L.alive = true;
  S.lsteps = 0;
}

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

// Take pixel `pixel`: its camera ray, key and slab entry.  Returns whether
// the primary entered the grid; else the pixel's radiance is bg_acc.
__device__ __forceinline__ bool start_pixel(const GiParams& G, const CameraParams& CP,
                                            const float4* subs, int pixel, Path& S,
                                            float* rad_out) {
  Lane& L = S.L;
  camera_ray_at(CP, subs, pixel, L.o, L.d);
  for (int k = 0; k < 3; ++k) L.invd[k] = 1.0f / L.d[k];
  float t0;
  bool entered;
  slab_entry(G.m, L.o, L.d, 0.0f, INFINITY, t0, entered);
  if (!entered) {
    for (int c = 0; c < 3; ++c) rad_out[3 * pixel + c] = G.bg_acc[c];
    return false;
  }
  S.key0 = ray_sample_key(L.o, L.d);
  S.maxt_seg = INFINITY;
  L.gate = G.gate0;
  L.t_cur = t0;
  L.t_exit_cell = 0.0f;
  L.best_t = L.p_best_t = INFINITY;
  L.first_blk = L.n_blk = L.cursor = 0;
  L.best_blk = L.best_slot = L.p_best_blk = L.p_best_slot = 0;
  L.alive = true;
  L.testing = L.phase = L.shadow_hit = false;
  S.lsteps = S.depth = S.samp = S.tested = 0;
  S.capped = S.vspec = false;
  S.vkm = S.km0 = 0.0f;
  for (int c = 0; c < 3; ++c) {
    S.rad[c] = S.vcur[c] = S.pend[c] = 0.0f;
    S.tpt[c] = 1.0f;
  }
  return true;
}

// The transition of a lane that ran this step.  Returns true when its
// pixel is done: its radiance is then written.
__device__ bool transition(const GiParams& G, Path& S, const int* slot_tri, const float* tri9,
                           const float* albedo, const float* km_tab,
                           unsigned long long ev[kEvents], float* rad_out, int pixel) {
  const MarchParams& P = G.m;
  Lane& L = S.L;
  const bool alive = L.alive;  // false: it walked off the grid
  const bool hit_now = finite(L.best_t);
  const bool timeout = alive && S.lsteps > G.seg_bound;
  S.capped = S.capped || timeout;
  bool seg_done = false, sh_done = false;
  if (!L.phase) {
    const float limit = nan_min(S.maxt_seg, L.best_t);
    seg_done = (alive && !L.testing && L.t_cur > limit) || !alive || timeout;
  } else {
    sh_done = (alive && hit_now) || !alive || timeout;
  }
  if (!seg_done && !sh_done) return false;
  const bool hitP = seg_done && hit_now;
  const bool missP = seg_done && !hit_now;
  const int depth_v = S.depth;
  float c_vtx[3] = {0.0f, 0.0f, 0.0f};
  bool imm = false;
  if (hitP) {  // resolve the vertex
    ++ev[kVertices];
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
    float poi_r[3], poi_m[3], a[3], b[3], cr[3], gn[3], n[3], to_l[3], wl[3];
    for (int k = 0; k < 3; ++k) {
      poi_r[k] = L.o[k] + L.d[k] * t_r;
      poi_m[k] = L.o[k] + L.d[k] * L.best_t;
      a[k] = v1[k] - v0[k];
      b[k] = v2[k] - v0[k];
    }
    cross3(a, b, cr);
    normalize3(cr, gn);
    const bool flip = dot3(gn, L.d) > 0.0f;
    for (int k = 0; k < 3; ++k) {
      n[k] = flip ? -gn[k] : gn[k];
      to_l[k] = P.light[k] - poi_r[k];
    }
    const float d2 = dot3(to_l, to_l);
    const float den = sqrtf(tiny_max(d2));
    for (int k = 0; k < 3; ++k) wl[k] = to_l[k] / den;
    const float cos_i = nan_max(dot3(n, wl), 0.0f);
    const float q = G.li * cos_i / tiny_max(d2);
    float pend_new[3];
    for (int c = 0; c < 3; ++c) {
      const float alb = albedo[3 * mat + c];
      pend_new[c] = S.tpt[c] * (alb * kInvPi * q);
      S.alb[c] = alb;
      S.nrm[c] = n[c];
      S.vpos[c] = poi_r[c];
      S.idir[c] = L.d[c];
    }
    bool spec_new = false;
    if (G.has_spec) {
      const float km_d = km_tab[mat];
      const float u3 = hash_u01(sample_key(S.key0, S.samp),
                                0x85EBCA77u * (uint32_t)(depth_v + 1) + 13u);
      spec_new = u3 < km_d;
      S.vkm = km_d;
      ev[kMirrors] += spec_new ? 1 : 0;
    }
    S.vspec = spec_new;
    // the shadow ray from the march's point: a divide by the norm
    float to_lm[3], sdir[3];
    for (int k = 0; k < 3; ++k) to_lm[k] = P.light[k] - poi_m[k];
    const float norm = sqrtf(dot3(to_lm, to_lm));
    const float nden = norm > 0.0f ? norm : 1.0f;
    for (int k = 0; k < 3; ++k) {
      sdir[k] = to_lm[k] / nden;
      if (G.quirk) sdir[k] = -sdir[k];  // Serial/raytracer.cpp:106
    }
    float st0;
    bool s_entered;
    slab_entry(P, poi_m, sdir, G.smint, INFINITY, st0, s_entered);
    const bool want_nee = cos_i > 0.0f && (!spec_new || depth_v == 0);
    if (want_nee && s_entered) {
      for (int c = 0; c < 3; ++c) S.pend[c] = pend_new[c];
      rearm(S, poi_m, sdir, st0, G.eps, true);
      ++ev[kShadows];
      return false;
    }
    imm = true;
    for (int c = 0; c < 3; ++c) {
      S.vcur[c] = S.vcur[c] + (!spec_new ? pend_new[c] : 0.0f);
      c_vtx[c] = pend_new[c] + 0.0f;
    }
  } else if (sh_done) {  // settle the staged NEE
    const bool nee_add = !hit_now;
    for (int c = 0; c < 3; ++c) {
      S.vcur[c] = S.vcur[c] + ((nee_add && !S.vspec) ? S.pend[c] : 0.0f);
      c_vtx[c] = 0.0f + (nee_add ? S.pend[c] : 0.0f);
    }
  }
  const bool av = imm || sh_done;
  if (av && depth_v == 0) {  // the shared depth-0 vertex
    for (int c = 0; c < 3; ++c) {
      S.d0[c] = c_vtx[c];
      S.poi0[c] = S.vpos[c];
      S.n0[c] = S.nrm[c];
      S.alb0[c] = S.alb[c];
      S.idir0[c] = S.idir[c];
    }
    S.km0 = S.vkm;
  }
  bool E = false;
  bool pix_done = false;
  if (av && depth_v < G.D) {  // the bounce
    const uint32_t key_s = sample_key(S.key0, S.samp);
    const uint32_t saltd = (uint32_t)(depth_v + 1);
    const float u1 = hash_u01(key_s, 0x1000193u * saltd);
    const float u2 = hash_u01(key_s, 0x5BD1E995u * saltd + 7u);
    float ndir[3], tpt_b[3];
    cosine_sample(S.nrm, u1, u2, ndir);
    if (G.has_spec && S.vspec) mirror(S.idir, S.nrm, ndir);
    for (int c = 0; c < 3; ++c) {
      tpt_b[c] = S.tpt[c] * ((G.has_spec && S.vspec) ? 1.0f : S.alb[c]);
    }
    float stb;
    bool entb;
    slab_entry(P, S.vpos, ndir, G.eps, INFINITY, stb, entb);
    if (entb) {
      rearm(S, S.vpos, ndir, stb, G.gate_b, false);
      S.depth = depth_v + 1;
      for (int c = 0; c < 3; ++c) S.tpt[c] = tpt_b[c];
      ++ev[kBounces];
      return false;
    }
    ++ev[kEscapes];  // the bounce misses the grid
    for (int c = 0; c < 3; ++c) S.vcur[c] = S.vcur[c] + tpt_b[c] * G.bg[c];
    E = true;
  } else if (av) {
    E = true;  // depth D reached
  } else if (missP && depth_v >= 1) {
    ++ev[kEscapes];
    for (int c = 0; c < 3; ++c) S.vcur[c] = S.vcur[c] + S.tpt[c] * G.bg[c];
    E = true;
  } else if (missP) {  // the primary missed: every sample sees the background
    for (int c = 0; c < 3; ++c) S.rad[c] = G.bg_acc[c];
    pix_done = true;
  }
  // the sample-end cascade: bank the sample, then restart the next one
  // from the shared depth-0 vertex
  while (E) {
    for (int c = 0; c < 3; ++c) S.rad[c] = S.rad[c] + S.vcur[c];
    S.samp += 1;
    if (S.samp >= G.S) {
      pix_done = true;
      break;
    }
    const uint32_t key_r = sample_key(S.key0, S.samp);
    bool spec_r = false;
    if (G.has_spec) {
      spec_r = hash_u01(key_r, 0x85EBCA77u + 13u) < S.km0;
      ev[kMirrors] += spec_r ? 1 : 0;
    }
    if (G.D == 0) {  // v_s is d0 for a diffuse draw, 0 for a mirror draw
      for (int c = 0; c < 3; ++c) S.vcur[c] = spec_r ? 0.0f : S.d0[c];
      continue;
    }
    const float u1 = hash_u01(key_r, 0x1000193u);
    const float u2 = hash_u01(key_r, 0x5BD1E995u + 7u);
    float ndir[3], tpt_r[3];
    cosine_sample(S.n0, u1, u2, ndir);
    if (spec_r) mirror(S.idir0, S.n0, ndir);
    for (int c = 0; c < 3; ++c) {
      tpt_r[c] = spec_r ? 1.0f : S.alb0[c];
      S.vcur[c] = spec_r ? 0.0f : S.d0[c];
    }
    float str;
    bool entr;
    slab_entry(P, S.poi0, ndir, G.eps, INFINITY, str, entr);
    if (entr) {
      rearm(S, S.poi0, ndir, str, G.gate_b, false);
      S.depth = 1;
      for (int c = 0; c < 3; ++c) {
        S.tpt[c] = tpt_r[c];
        S.idir[c] = ndir[c];
      }
      S.vspec = spec_r;
      ++ev[kBounces];
      return false;
    }
    ++ev[kEscapes];
    for (int c = 0; c < 3; ++c) S.vcur[c] = S.vcur[c] + tpt_r[c] * G.bg[c];
  }
  if (!pix_done) return false;  // not reached: every ended segment rearms or ends a sample
  for (int c = 0; c < 3; ++c) rad_out[3 * pixel + c] = S.rad[c];
  return true;
}

__global__ void __launch_bounds__(kBlock)
gi_wave_kernel(GiParams G, CameraParams CP, const float4* __restrict__ subs,
               const int* __restrict__ cell_info, const float* __restrict__ blocks,
               const int* __restrict__ slot_tri, const float* __restrict__ tri9,
               const float* __restrict__ albedo, const float* __restrict__ km_tab,
               float* __restrict__ rad_out, Counters C) {
  const MarchParams& P = G.m;
  const int pixel = blockIdx.x * kBlock + threadIdx.x;
  Path S;
  unsigned long long ev[kEvents] = {0, 0, 0, 0, 0, 0, 0};
  bool active = pixel < P.n_rays && start_pixel(G, CP, subs, pixel, S, rad_out);
  ev[kPrimaries] += active ? 1 : 0;
  int capped = 0;
  long long tested = 0;
  for (;;) {
    if (__ballot_sync(kFull, active) == 0u) break;
    const int blk = active ? step_fetch(P, S.L, cell_info, blocks, nullptr) : -1;
    float m;
    int slot;
    rows_min_warp(P, blocks, blk, S.L, S.maxt_seg, C.passes, m, slot);
    if (!active) continue;
    step_finish(P, S.L, blk, m, slot, cell_info, blocks, nullptr, S.tested);
    ++S.lsteps;
    if (transition(G, S, slot_tri, tri9, albedo, km_tab, ev, rad_out, pixel)) {
      capped += S.capped ? 1 : 0;
      tested += S.tested;
      active = false;
    }
  }
  ev[kSlotTests] = (unsigned long long)tested * (unsigned long long)P.block_tris;
  // every thread of the warp is here: fold the counters a warp at a time
  const bool lead = (threadIdx.x & 31) == 0;
  if (C.capped != nullptr) {
    const int c = __reduce_add_sync(kFull, capped);
    if (lead && c != 0) atomicAdd(C.capped, c);
  }
  if (C.events != nullptr) {
    for (int e = 0; e < kEvents; ++e) {
      unsigned long long c = ev[e];
      for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(kFull, c, off);
      if (lead && c != 0) atomicAdd(C.events + e, c);
    }
  }
}

}  // namespace

// Launch kernel F over the n_rays = G.m.n_rays pixels of camera CP: subs
// (1, 4) f32 [ox, oy, lx, ly]; cell_info (n_cells,) or (1,) i32, blocks
// (n_blocks, row_lanes) f32, slot_tri (n_slots,) i32, tri9 (n_faces, 10)
// f32, albedo (n_mats, 3) f32, km (n_mats,) f32 or null (no mirror mix);
// rad (n_rays, 3) f32 out, every row written.  The counters are null when
// not wanted, else zeroed by the caller.  Returns the first CUDA error.
extern "C" int gi_wave_launch(GiParams G, CameraParams CP, const float* subs,
                              const int* cell_info, const float* blocks, const int* slot_tri,
                              const float* tri9, const float* albedo, const float* km,
                              float* rad, int* capped, int* passes,
                              unsigned long long* events, void* stream) {
  if (G.has_spec && km == nullptr) return (int)cudaErrorInvalidValue;
  const Counters C{capped, passes, events};
  const long long blocks_needed = ((long long)G.m.n_rays + kBlock - 1) / kBlock;
  if (blocks_needed == 0) return 0;
  gi_wave_kernel<<<(unsigned)blocks_needed, kBlock, 0, (cudaStream_t)stream>>>(
      G, CP, reinterpret_cast<const float4*>(subs), cell_info, blocks, slot_tri, tri9, albedo,
      km, rad, C);
  return (int)cudaGetLastError();
}
