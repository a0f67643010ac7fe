// Texture and environment lookups on the card: the texture factor
// (checker and bilinear image) and the lat-long environment map.
//
// Counterpart of ray_tracer_tpu/models/scenes.py:sample_texture_image
// (:164), texture_factor (:188) and sample_env_image (:211), and bitwise
// equal to the port's plain copies (ray_tracer_tpu_torch/models/scenes.py)
// run on the card: every file that includes this header builds with
// -fmad=false, without fast math and with IEEE division, so each product,
// sum and divide rounds on its own; atan2f and acosf are the libdevice
// functions torch's CUDA atan2 and acos call.
//   * jnp.mod on int32 is a floor-mod, C's % truncates: floor_mod.
//   * x % 2.0 on floats is jnp.remainder, fmod then a sign fix-up: fmod2.
//   * the f32 -> int32 cast is XLA's: NaN -> 0, saturating (to_i32).
//   * / (2 pi) and / pi are true divides by the float32 constants.
// Texels are read from global memory with __ldg, never through texture
// objects, whose hardware filtering has 8-bit fixed-point weights.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "packed_step.cuh"

// The appearance tables of a launch, passed by value from ctypes (the
// layout of ops/gi_wave._AppearParams).  A null table turns its feature
// off: env the (env_h, env_w, 3) lat-long map in color units; fvn9 the
// (F, 9) corner normals of smooth shading; fuv7 the (F, 7) corner uvs and
// has-uv flag, with bc255 the (M, 3) raw base color / 255, of a texture;
// tex the (tex_h, tex_w, 3) image of the image mode (null: the checker).
struct AppearParams {
  const float* env;
  const float* fvn9;
  const float* fuv7;
  const float* tex;
  const float* bc255;
  float tex_scale;
  int env_h, env_w, tex_h, tex_w;
};

namespace {

enum TexMode { kTexNone = 0, kTexChecker = 1, kTexImage = 2 };

constexpr float kTwoPiF = 6.283185307179586f;
constexpr float kPiF = 3.141592653589793f;

// XLA's float32 -> int32 convert: NaN -> 0, saturating, truncation.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return (-2147483647 - 1);
  return (int)x;
}

// jnp.mod for int32 and n > 0: the floor-mod.
__device__ __forceinline__ int floor_mod(int a, int n) { return ((a % n) + n) % n; }

// x % 2.0 as jnp.remainder: fmod, plus 2 where the remainder is nonzero
// and negative.
__device__ __forceinline__ float fmod2(float x) {
  float r = fmodf(x, 2.0f);
  if (r != 0.0f && r < 0.0f) r = r + 2.0f;
  return r;
}

// The bilinear blend of an (h, w, 3) image, u first: top + (bot - top) * fv.
__device__ __forceinline__ void bilinear(const float* img, int w, int iv0, int iu0, int iv1,
                                         int iu1, float fu, float fv, float out[3]) {
  const float* c00 = img + 3 * ((size_t)iv0 * w + iu0);
  const float* c01 = img + 3 * ((size_t)iv0 * w + iu1);
  const float* c10 = img + 3 * ((size_t)iv1 * w + iu0);
  const float* c11 = img + 3 * ((size_t)iv1 * w + iu1);
  for (int c = 0; c < 3; ++c) {
    const float a = __ldg(c00 + c), b = __ldg(c01 + c);
    const float e = __ldg(c10 + c), f = __ldg(c11 + c);
    const float top = a + (b - a) * fu;
    const float bot = e + (f - e) * fu;
    out[c] = top + (bot - top) * fv;
  }
}

// sample_texture_image at one uv: wrap mode, v = 0 the bottom row.
__device__ __forceinline__ void sample_texture(const float* tex, int th, int tw, float us,
                                               float vs, float out[3]) {
  const float u = us * (float)tw - 0.5f;
  const float v = (1.0f - vs) * (float)th - 0.5f;
  const float u0f = floorf(u), v0f = floorf(v);
  const int iu0 = floor_mod(to_i32(u0f), tw);
  const int iv0 = floor_mod(to_i32(v0f), th);
  bilinear(tex, tw, iv0, iu0, floor_mod(iv0 + 1, th), floor_mod(iu0 + 1, tw), u - u0f,
           v - v0f, out);
}

// texture_factor on a hit lane: the (broadcast) factor that multiplies the
// base color, 1 where the face has no uv.
template <int kTex>
__device__ __forceinline__ void texture_factor(const AppearParams& A, const float uv[2],
                                               bool has_uv, float out[3]) {
  const float n = A.tex_scale;
  if constexpr (kTex == kTexChecker) {
    const float checker = fmod2(floorf(uv[0] * n) + floorf(uv[1] * n));
    const float f = has_uv ? 1.0f - 0.5f * checker : 1.0f;
    out[0] = out[1] = out[2] = f;
  } else {
    float rgb[3];
    sample_texture(A.tex, A.tex_h, A.tex_w, uv[0] * n, uv[1] * n, rgb);
    for (int c = 0; c < 3; ++c) out[c] = has_uv ? rgb[c] : 1.0f;
  }
}

// sample_env_image of the normalized direction d: u the azimuth around +y
// (wraps), v the polar angle from +y, clamped at the pole texel centres.
__device__ __forceinline__ void sample_env(const AppearParams& A, const float dir[3],
                                           float out[3]) {
  float d[3];
  normalize3(dir, d);
  const int th = A.env_h, tw = A.env_w;
  const float u = atan2f(d[2], d[0]) / kTwoPiF + 0.5f;
  const float v = acosf(nan_min(nan_max(d[1], -1.0f), 1.0f)) / kPiF;
  const float uu = u * (float)tw - 0.5f;
  const float vv = nan_min(nan_max(v * (float)th - 0.5f, 0.0f), (float)th - 1.0f);
  const float u0f = floorf(uu), v0f = floorf(vv);
  const int iu0 = floor_mod(to_i32(u0f), tw);
  const int iv0 = clampi(to_i32(v0f), 0, th - 1);
  bilinear(A.env, tw, iv0, iu0, clampi(iv0 + 1, 0, th - 1), floor_mod(iu0 + 1, tw), uu - u0f,
           vv - v0f, out);
}

}  // namespace
