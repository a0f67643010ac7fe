// camera_ray_at on the card: the camera ray of one queue position, made
// from its index with no gather, bitwise equal to the port's CPU batch
// (ops/camera.camera_rays, itself equal to the JAX package's op-by-op
// ray_tracer_tpu/ops/camera.py:camera_ray_at, :145-186).
//
// Position idx = s*H*W + y*W + x holds subsample s of pixel (x, y):
//
//     xw  = aspect * ((x - W/2) + ox) / W,   yw = ((y - H/2) + oy) / H
//     dir = normalize(((-w)*fd + u*xw) + v*yw)
//
// and, with the thin lens, the origin moves to (pos + u*lx) + v*ly and the
// direction re-aims at pos + dir*(focus / -dot(dir, w)).  The basis (pos,
// u, v, w) comes from camera_basis on the CPU and reaches the kernel as
// launch parameters, never normalized here; fd, aspect, W/2, H/2, W, H and
// focus are the Python floats the batch narrows to f32; each subsample's
// (ox, oy, lx, ly) comes from a host table of the same Python floats
// (ops/camera.subsample_table), since an f32 (s+0.5)/spp on the card would
// not be the host's.  Every file that includes this header builds with
// -fmad=false and without fast math: IEEE '/' and sqrtf, each product and
// sum rounded on its own, in the batch's order.
#pragma once

#include <cuda_runtime.h>

#include "packed_step.cuh"

// The camera's launch parameters (the layout of ops/whitted_wave._CameraParams).
struct CameraParams {
  float pos[3], u[3], v[3], w[3];
  float fd, aspect, half_w, half_h, fw, fh, focus;
  int width, height, n_sub, lens;
};

namespace {

// The ray of position idx (0 <= idx < n_sub*H*W): origin o, unit direction d.
__device__ __forceinline__ void camera_ray_at(const CameraParams& CP,
                                              const float4* __restrict__ subs, int idx,
                                              float o[3], float d[3]) {
  const int hw = CP.width * CP.height;
  const int p = idx % hw;
  const int s = clampi(idx / hw, 0, CP.n_sub - 1);
  const float4 t = subs[s];  // ox, oy, lx, ly
  const float xi = (float)(p % CP.width);
  const float yi = (float)(p / CP.width);
  const float xw = (CP.aspect * ((xi - CP.half_w) + t.x)) / CP.fw;
  const float yw = ((yi - CP.half_h) + t.y) / CP.fh;
  float dir[3];
  for (int k = 0; k < 3; ++k) dir[k] = ((-CP.w[k]) * CP.fd + CP.u[k] * xw) + CP.v[k] * yw;
  normalize3(dir, d);
  if (!CP.lens) {
    for (int k = 0; k < 3; ++k) o[k] = CP.pos[k];
    return;
  }
  const float cosw = -dot3(d, CP.w);
  const float q = CP.focus / cosw;
  float aim[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = (CP.pos[k] + CP.u[k] * t.z) + CP.v[k] * t.w;
    aim[k] = (CP.pos[k] + d[k] * q) - o[k];
  }
  normalize3(aim, d);
}

}  // namespace
