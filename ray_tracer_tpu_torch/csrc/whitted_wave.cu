// Kernel E: the cross-depth Whitted wave, a persistent wave of lanes that
// pop pixel subsamples from a queue and make their camera rays.
//
// Replaces K5, ray_tracer_tpu/ops/whitted_wave.py:whitted_wave_trace (:79),
// the lax while_loop in which W lanes pop pixels from a cumsum queue and
// serve each pixel's whole mirror recursion
//
//     primary march -> shadow march -> shade -> mirror bounce -> shadow ...
//
// and write one color a pixel (subsample-major when spp > 1; the wrapper
// folds the subsamples).
//
// Per queue position: its camera ray from its index (camera.cuh's
// camera_ray_at, the JAX wave's refill source, with no ray batch in
// memory), the slab entry, then march steps through packed_step.cuh and,
// after every step, the JAX loop's transition (whitted_wave.py:257-431):
//   * a path segment (the primary or a mirror ray) retires when it walks
//     past min(maxt, best_t) between cells, walks off the grid, or has
//     stepped more than seg_bound times.  On a hit the vertex resolves
//     through slot_tri, its (F, 10) triangle row and (M, 9) material row;
//     t is recomputed (cramer_t_safe) for the shading point; the vertex is
//     shaded per variant; and the lane rearms as its shadow ray from the
//     march's own hit point (mint smint, gate eps, the serial quirk).  The
//     serial variant skips the shadow ray exactly when its direct term A
//     is zero (ambient lands after the shadow scale there).  On a miss the
//     depth's local color is the background.
//   * a shadow segment retires at its first accepted hit, off the grid or
//     at the step bound.  The vertex's color (A, scaled when occluded, plus
//     B) blends forward, col += w * local with w the product of the km's,
//     and a reflective vertex below max_bounces rearms as its mirror ray
//     from the recomputed point (gate gate_b, mint eps); a mirror ray that
//     misses the grid adds the background at its weight.
//
// Design.  A pixel's work ranges from nothing (its primary misses the
// grid) to eight segments (three mirror bounces, each with its shadow ray).
// The wave is persistent: as many blocks as stay resident on the card (SMs
// x the occupancy calculator's blocks an SM), each thread looping until
// the queue is empty.  When half of a warp's lanes or more are idle (or
// all are) at the top of a step, the idle lanes take the next positions
// of a warp-local pool of kChunk consecutive positions by their prefix
// popcount (the JAX cumsum queue, a warp at a time); lane 0 takes a new
// chunk from a global counter with one atomicAdd when the pool runs dry.
// A lane whose ray misses the grid writes the background and takes the
// next position in the same round.  The threshold is measured (PERF.md):
// refilling every step lifts the lane utilisation from 0.73 to 0.92-0.95
// but costs 9-22% more time, since lanes at other phases of their pixels
// make a warp execute the union of their code, the shading included,
// every step; refilling at half a warp keeps most lanes in step and beats
// one thread a position by about 2%.  The warp still deals out the slots
// of every row its lanes test in a step (rows_min_warp), so every lane
// joins every step: the refill happens before the step's shared fetch,
// and the loop ends when the queue is empty and no lane is active.
// Colors and counters do not depend on the schedule (the JAX wave's
// colors do not, for any wave width and pump): `tested` is indexed by
// position, `slots` and `touched` are idempotent flags, `passes`,
// `capped` and `events` integer sums.  A lane holds its pixel's march
// state (packed_step.cuh's Lane, one definition with C) and, across the
// shadow march, the staged vertex (A, B, tint, km, normal, shading point,
// incident direction).
//
// Exactness against the plain version (ops/whitted_wave.whitted_wave_plain):
// -fmad=false and no fast math; the wave's own expression orders, not
// ops/shade.py's: serial A = specular + diffuse with base*(kd*ndl)*li and
// base*(ks*pow)*li, B = base*ka; parallel A = (diffuse + specular) +
// base*ka with (base*ndl)*kd and (base*pow)*ks, B = 0; h unnormalized in
// serial and normalized in parallel.  The shadow direction divides by the
// norm (not normalize's 1/sqrt); the reflection is normalize(nd -
// nn*(2*dot)) of the normalized staged incident direction; the color sums
// col + w*local, then + w*bg on a miss, then + w'*bg on an escaping bounce.
// powf is the function PyTorch's CUDA pow calls for float tensors
// (ATen/native/cuda/Pow.cuh: ::pow(float, float)).  The camera rays equal
// the CPU batch's bits (camera.cuh).
//
// Bound on the H100: FP32 operations rather than bytes on the turbo
// parallel frame (chip_smoke.py reports both from the kernel's counters:
// rows and slots tested, barycentric passes, vertices and reflections).
// The kernel stands far from it, bound by instruction issue as C is: a
// warp executes the union of its lanes' paths, the shading of a vertex
// included, and a step's row tests are dealt over the warp.  The optional
// `lanes` counter reports the warp iterations and the lane-steps that
// marched in them (their ratio over 32 is the lane utilisation).
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "camera.cuh"
#include "packed_step.cuh"

// The launch's scalars, passed by value from ctypes (the layout of
// ops/whitted_wave._WaveParams).  m holds the grid, the light and the
// layout (its gate, fused, skip and chain fields are not read: the JAX
// wave probes one cell a step); m.n_rays is the queue's length.  Queue
// position k serves subsample pix_offset + k * pix_stride of the camera's
// n_pix (the sharded queue of the JAX wave; 0, 1 and n_rays unsharded);
// a position past n_pix is dead and holds the background.
struct WaveParams {
  MarchParams m;
  float li, shadow_scale, gate0, gate_b, eps, smint;
  float bg[3];
  int serial, quirk, max_bounces, seg_bound, n_faces, n_mats;
  int pix_offset, pix_stride, n_pix;
};

namespace {

constexpr int kBlock = 128;
constexpr int kMinBlocks = 4;  // at most 128 registers a thread
constexpr int kEvents = 5;
constexpr int kChunk = 32;     // positions a warp takes from the queue at once
constexpr int kRefillAt = 16;  // idle lanes that make a warp refill

// Optional counters (null when not wanted), zeroed by the caller.
struct Counters {
  int* capped;   // positions a segment of which reached the step bound
  int* passes;   // tested slots that passed the barycentric test
  int* tested;   // rows tested, per position
  int* touched;  // per row: |1 header read, |2 triangles tested
  int* slots;    // per slot: 1 where a vertex resolved it
  int* events;   // primaries entered, vertices, shadow rays, reflections, mirror rays
  unsigned long long* lanes;  // warp loop iterations, active lane-steps
};

// The vertex staged when a path segment retires on a hit and consumed
// after its shadow segment.
struct Vertex {
  float A[3], B[3], tint[3], nrm[3], pos[3], idir[3];
  float km;
  bool rgo;  // reflective and below max_bounces: a mirror ray follows
};

// A lane's pixel: its march state, staged vertex and forward sums.
struct Pixel {
  Lane L;
  Vertex V;
  float col[3];
  float wgt, maxt_seg;
  int position, lsteps, depth, tested;
  bool capped;
};

// jnp.maximum(0.0, x), NaN kept.
__device__ __forceinline__ float relu(float x) { return nan_max(0.0f, x); }

// shade._pow_safe: C pow() for base >= 0 (0^a = 0 for a > 0, 0^0 = 1).
__device__ __forceinline__ float pow_safe(float base, float e) {
  if (base > 0.0f) return powf(base, e);
  return e == 0.0f ? 1.0f : 0.0f;
}

// Start a segment in place (the JAX loop's rearm).
__device__ __forceinline__ void rearm(Lane& L, float& maxt_seg, int& lsteps,
                                      const float o[3], const float d[3], float t0,
                                      float gate, bool phase) {
  for (int k = 0; k < 3; ++k) {
    L.o[k] = o[k];
    L.d[k] = d[k];
    L.invd[k] = 1.0f / d[k];
  }
  L.t_cur = t0;
  L.gate = gate;
  maxt_seg = INFINITY;
  L.best_t = INFINITY;
  L.best_blk = 0;
  L.best_slot = 0;
  L.cursor = 0;
  L.testing = false;
  L.phase = phase;
  L.alive = true;
  lsteps = 0;
}

// Resolve and shade the vertex of a path segment that retired on a hit:
// fills V and the march's hit point poi_m.
__device__ void resolve_vertex(const WaveParams& W, const Lane& L, int depth,
                               const int* slot_tri, const float* tri9, const float* mat9,
                               int* slots, Vertex& V, float poi_m[3]) {
  const MarchParams& P = W.m;
  const int slot = clampi(L.best_blk * P.block_tris + L.best_slot, 0, P.n_slots - 1);
  if (slots != nullptr) slots[slot] = 1;
  const int tri = clampi(slot_tri[slot], 0, W.n_faces - 1);
  const float* row = tri9 + (size_t)tri * 10;
  const float* v0 = row;
  const float* v1 = row + 3;
  const float* v2 = row + 6;
  const float* m = mat9 + (size_t)clampi((int)row[9], 0, W.n_mats - 1) * 9;
  // cramer_t_safe on a valid lane: tn / A, or 0 where A == 0
  float e1[3], e2[3], s[3];
  for (int k = 0; k < 3; ++k) {
    e1[k] = v0[k] - v1[k];
    e2[k] = v0[k] - v2[k];
    s[k] = v0[k] - L.o[k];
  }
  const float A = det3(e1[0], e2[0], L.d[0], e1[1], e2[1], L.d[1], e1[2], e2[2], L.d[2]);
  const float tn = det3(e1[0], e2[0], s[0], e1[1], e2[1], s[1], e1[2], e2[2], s[2]);
  const bool guard = A != 0.0f;
  const float t_r = (guard ? tn : 0.0f) / (guard ? A : 1.0f);
  float n[3], a[3], b[3], view[3], l[3], h[3], nd[3], tl[3];
  for (int k = 0; k < 3; ++k) {
    V.pos[k] = L.o[k] + L.d[k] * t_r;
    poi_m[k] = L.o[k] + L.d[k] * L.best_t;
    V.idir[k] = L.d[k];
    nd[k] = -L.d[k];
    tl[k] = P.light[k] - V.pos[k];
  }
  if (W.serial) {  // getNormalMod, Serial/geometry.h:234-240
    for (int k = 0; k < 3; ++k) {
      a[k] = v0[k] - v1[k];
      b[k] = v2[k] - v0[k];
    }
  } else {  // Parallel/geometry.cuh:160
    for (int k = 0; k < 3; ++k) {
      a[k] = v2[k] - v1[k];
      b[k] = v0[k] - v1[k];
    }
  }
  cross3(a, b, n);
  normalize3(nd, view);
  normalize3(tl, l);
  for (int k = 0; k < 3; ++k) h[k] = view[k] + l[k];
  if (!W.serial) {  // serial keeps h unnormalized (raytracer.cpp:95)
    float hn[3];
    normalize3(h, hn);
    for (int k = 0; k < 3; ++k) h[k] = hn[k];
  }
  const float ndl = relu(dot3(n, l));
  const float ndh = relu(dot3(n, h));
  const float kd = m[3], ks = m[4], alpha = m[5], ka = m[6];
  const float p = pow_safe(ndh, alpha);
  for (int c = 0; c < 3; ++c) {
    const float base = m[c];
    if (W.serial) {
      const float diffuse = base * (kd * ndl) * W.li;
      const float specular = base * (ks * p) * W.li;
      V.A[c] = specular + diffuse;
      V.B[c] = base * ka;  // ambient lands after the shadow scale
    } else {
      const float diffuse = base * ndl * kd;
      const float specular = base * p * ks;
      V.A[c] = (diffuse + specular) + base * ka;  // the shadow scales ambient too
      V.B[c] = 0.0f;
    }
    V.tint[c] = base;
    V.nrm[c] = n[c];
  }
  V.km = m[7];
  V.rgo = m[8] > 0.5f && depth < W.max_bounces;
}

// Take queue position `position`: make the camera ray of its subsample
// gid = pix_offset + position * pix_stride (written to rays_out when
// given: origin, direction, mint 0, maxt +inf; a dead position's is the
// last subsample's) and its slab entry.  Returns whether the primary
// entered the grid; else (or when gid >= n_pix) the background is the
// position's color.
__device__ __forceinline__ bool start_pixel(const WaveParams& W, const CameraParams& CP,
                                            const float4* subs, int position, Pixel& S,
                                            float* color, float* rays_out) {
  const MarchParams& P = W.m;
  Lane& L = S.L;
  const long long gid = (long long)W.pix_offset + (long long)position * W.pix_stride;
  const bool live = gid < W.n_pix;
  camera_ray_at(CP, subs, live ? (int)gid : W.n_pix - 1, L.o, L.d);
  if (rays_out != nullptr) {
    float* row = rays_out + (size_t)position * 8;
    for (int k = 0; k < 3; ++k) {
      row[k] = L.o[k];
      row[3 + k] = L.d[k];
    }
    row[6] = 0.0f;
    row[7] = INFINITY;
  }
  for (int k = 0; k < 3; ++k) L.invd[k] = 1.0f / L.d[k];
  S.maxt_seg = INFINITY;
  float t0 = 0.0f;
  bool entered = false;
  if (live) slab_entry(P, L.o, L.d, 0.0f, INFINITY, t0, entered);
  if (!entered) {
    for (int c = 0; c < 3; ++c) color[3 * position + c] = W.bg[c];
    return false;
  }
  L.gate = W.gate0;
  L.t_cur = t0;
  L.t_exit_cell = 0.0f;
  L.best_t = INFINITY;
  L.p_best_t = INFINITY;
  L.first_blk = L.n_blk = L.cursor = 0;
  L.best_blk = L.best_slot = L.p_best_blk = L.p_best_slot = 0;
  L.alive = true;
  L.testing = L.phase = L.shadow_hit = false;
  S.position = position;
  S.col[0] = S.col[1] = S.col[2] = 0.0f;
  S.wgt = 1.0f;
  S.lsteps = S.depth = S.tested = 0;
  S.capped = false;
  return true;
}

// The transition of a lane that ran this step.  Returns true when its
// pixel is done: its color is then written.
__device__ __forceinline__ bool transition(const WaveParams& W, Pixel& S, const int* slot_tri,
                                           const float* tri9, const float* mat9, int* slots,
                                           int ev[kEvents], float* color) {
  const MarchParams& P = W.m;
  Lane& L = S.L;
  Vertex& V = S.V;
  const bool alive = L.alive;  // false: it walked off the grid
  const bool hit_now = finite(L.best_t);
  const bool timeout = alive && S.lsteps > W.seg_bound;
  S.capped = S.capped || timeout;
  bool occ = false;
  bool done = false;
  if (!L.phase) {
    const float limit = nan_min(S.maxt_seg, L.best_t);
    if (!((alive && !L.testing && L.t_cur > limit) || !alive || timeout)) return false;
    if (!hit_now) {  // a miss: the depth's local color is the background
      for (int c = 0; c < 3; ++c) S.col[c] = S.col[c] + S.wgt * W.bg[c];
      done = true;
    } else {
      float poi_m[3], to_l[3], sdir[3];
      resolve_vertex(W, L, S.depth, slot_tri, tri9, mat9, slots, V, poi_m);
      ++ev[1];
      for (int k = 0; k < 3; ++k) to_l[k] = P.light[k] - poi_m[k];
      const float norm = sqrtf(dot3(to_l, to_l));
      const float den = norm > 0.0f ? norm : 1.0f;
      for (int k = 0; k < 3; ++k) {
        sdir[k] = to_l[k] / den;
        if (W.quirk) sdir[k] = -sdir[k];  // Serial/raytracer.cpp:106
      }
      float st0;
      bool s_entered;
      slab_entry(P, poi_m, sdir, W.smint, INFINITY, st0, s_entered);
      const bool want = !W.serial || V.A[0] != 0.0f || V.A[1] != 0.0f || V.A[2] != 0.0f;
      if (want && s_entered) {
        rearm(L, S.maxt_seg, S.lsteps, poi_m, sdir, st0, W.eps, true);
        ++ev[2];
        return false;
      }
    }
  } else {
    if (!((alive && hit_now) || !alive || timeout)) return false;
    occ = hit_now;
  }
  if (!done) {  // the vertex's color, then its mirror ray
    for (int c = 0; c < 3; ++c) {
      const float color_v = (occ ? V.A[c] * W.shadow_scale : V.A[c]) + V.B[c];
      const float local = V.rgo ? color_v * V.tint[c] * (1.0f - V.km) : color_v;
      S.col[c] = S.col[c] + S.wgt * local;
    }
    if (V.rgo) {
      S.wgt = S.wgt * V.km;
      ++ev[3];
      float nd[3], nn[3], r[3], rdir[3];
      normalize3(V.idir, nd);
      normalize3(V.nrm, nn);
      const float two = 2.0f * dot3(nd, nn);
      for (int k = 0; k < 3; ++k) r[k] = nd[k] - nn[k] * two;
      normalize3(r, rdir);
      float stb;
      bool entb;
      slab_entry(P, V.pos, rdir, W.eps, INFINITY, stb, entb);
      if (entb) {
        rearm(L, S.maxt_seg, S.lsteps, V.pos, rdir, stb, W.gate_b, false);
        ++S.depth;
        ++ev[4];
        return false;
      }
      // an off-grid mirror ray is the next depth's miss
      for (int c = 0; c < 3; ++c) S.col[c] = S.col[c] + S.wgt * W.bg[c];
    }
  }
  for (int c = 0; c < 3; ++c) color[3 * S.position + c] = S.col[c];
  return true;
}

// The persistent wave: each thread serves queue positions through their
// recursions until the queue (`head`, zeroed by the caller) is empty.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
whitted_wave_kernel(WaveParams W, CameraParams CP, const float4* __restrict__ subs,
                    const int* __restrict__ cell_info, const float* __restrict__ blocks,
                    const int* __restrict__ slot_tri, const float* __restrict__ tri9,
                    const float* __restrict__ mat9, float* __restrict__ color,
                    float* __restrict__ rays_out, int* __restrict__ head, Counters C) {
  const MarchParams& P = W.m;
  const int n = P.n_rays;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Pixel S;
  int ev[kEvents] = {0, 0, 0, 0, 0};
  int capped = 0;
  bool active = false;
  bool drained = false;
  int pool = 0, pool_end = 0;  // the warp's unserved positions [pool, pool_end)
  long long iters = 0, lane_steps = 0;  // this warp's, kept by lane 0
  for (;;) {
    // with half the warp idle, idle lanes take the next positions until
    // every lane marches or the queue is empty
    while (!drained) {
      const unsigned idle = __ballot_sync(kFull, !active);
      if (idle != kFull && __popc(idle) < kRefillAt) break;
      if (pool >= pool_end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(head, kChunk);
        base = __shfl_sync(kFull, base, 0);
        if (base >= n) {
          drained = true;
          break;
        }
        pool = base;
        pool_end = base + kChunk < n ? base + kChunk : n;
      }
      const int rank = __popc(idle & below);
      if (!active && rank < pool_end - pool) {
        active = start_pixel(W, CP, subs, pool + rank, S, color, rays_out);
        ev[0] += active ? 1 : 0;
      }
      const int took = __popc(idle) < pool_end - pool ? __popc(idle) : pool_end - pool;
      pool += took;
    }
    const unsigned marching = __ballot_sync(kFull, active);
    if (marching == 0u) break;
    ++iters;
    lane_steps += __popc(marching);
    const int blk = active ? step_fetch(P, S.L, cell_info, blocks, C.touched) : -1;
    float m;
    int slot;
    rows_min_warp(P, blocks, blk, S.L, S.maxt_seg, C.passes, m, slot);
    if (!active) continue;
    step_finish(P, S.L, blk, m, slot, cell_info, blocks, C.touched, S.tested);
    ++S.lsteps;
    if (transition(W, S, slot_tri, tri9, mat9, C.slots, ev, color)) {
      if (C.tested != nullptr) C.tested[S.position] = S.tested;
      capped += S.capped ? 1 : 0;
      active = false;
    }
  }
  // every thread of the warp is here: fold the counters a warp at a time
  const bool lead = lane == 0;
  if (C.capped != nullptr) {
    const int c = __reduce_add_sync(kFull, capped);
    if (lead && c != 0) atomicAdd(C.capped, c);
  }
  if (C.events != nullptr) {
    for (int e = 0; e < kEvents; ++e) {
      const int c = __reduce_add_sync(kFull, ev[e]);
      if (lead && c != 0) atomicAdd(C.events + e, c);
    }
  }
  if (C.lanes != nullptr && lead && iters != 0) {
    atomicAdd(C.lanes, (unsigned long long)iters);
    atomicAdd(C.lanes + 1, (unsigned long long)lane_steps);
  }
}

}  // namespace

// Launch kernel E over the n_rays = W.m.n_rays queue positions of camera
// CP (position k the subsample W.pix_offset + k * W.pix_stride): subs (n_sub, 4) f32 [ox, oy, lx, ly]; cell_info (n_cells,) or (1,)
// i32, blocks (n_blocks, row_lanes) f32, slot_tri (n_slots,) i32, tri9
// (n_faces, 10) f32, mat9 (n_mats, 9) f32; color (n_rays, 3) f32 out, every
// row written; rays_out (n_rays, 8) f32 or null; head (1,) i32 zeroed by
// the caller (the queue's counter).  The counters are null when not
// wanted, else zeroed by the caller.  Returns the first CUDA error.
extern "C" int whitted_wave_launch(
    WaveParams W, CameraParams CP, const float* subs, const int* cell_info,
    const float* blocks, const int* slot_tri, const float* tri9, const float* mat9,
    float* color, float* rays_out, int* head, int* capped, int* passes, int* tested,
    int* touched, int* slots, int* events, unsigned long long* lanes, void* stream) {
  const Counters C{capped, passes, tested, touched, slots, events, lanes};
  const long long need = ((long long)W.m.n_rays + kBlock - 1) / kBlock;
  if (need == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, whitted_wave_kernel, kBlock, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  whitted_wave_kernel<<<(unsigned)(need < resident ? need : resident), kBlock, 0,
                        (cudaStream_t)stream>>>(W, CP, reinterpret_cast<const float4*>(subs),
                                                cell_info, blocks, slot_tri, tri9, mat9, color,
                                                rays_out, head, C);
  return (int)cudaGetLastError();
}
