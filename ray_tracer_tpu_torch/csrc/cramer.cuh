// The Cramer ray/triangle solve shared by the port's CUDA kernels.
//
// Counterpart of ray_tracer_tpu/ops/intersect.py:cramer_tbg and of the
// arithmetic inside ray_tracer_tpu/ops/pallas_intersect.py:_kernel.  Both
// solve orig + t*dir = v0 + beta*(v1-v0) + gamma*(v2-v0) from the columns
// e1 = v0 - v1, e2 = v0 - v2, s = v0 - orig, with every determinant in the
// reference's expansion order t1 - t2 + t3 (Serial/raytracer.cpp:203-211;
// the Pallas kernel's numerators are the same products with some factors
// commuted, which is exact in IEEE arithmetic).  They differ in the last
// step only:
//   * cramer_tbg, and so the CSR DDA, DIVIDES each numerator by A;
//   * the Pallas kernel forms 1/A once and MULTIPLIES (pallas_intersect.py:76-79).
// kReciprocal selects which.  Every file that includes this header is
// compiled with -fmad=false and without fast math, so each product and sum
// rounds on its own, as in the plain PyTorch versions that run one
// elementwise op at a time.
#pragma once

template <typename T>
__device__ __forceinline__ T det3(T a1, T a2, T a3, T b1, T b2, T b3, T c1,
                                  T c2, T c3) {
  const T t1 = a1 * (b2 * c3 - b3 * c2);
  const T t2 = a2 * (b1 * c3 - b3 * c1);
  const T t3 = a3 * (b1 * c2 - b2 * c1);
  return t1 - t2 + t3;
}

// (t, beta, gamma) from the columns e1, e2, s and the direction d.
template <typename T, bool kReciprocal>
__device__ __forceinline__ void cramer_columns(const T e1[3], const T e2[3],
                                               const T s[3], const T d[3],
                                               T& t, T& beta, T& gamma) {
  const T A = det3(e1[0], e2[0], d[0], e1[1], e2[1], d[1], e1[2], e2[2], d[2]);
  const T tn = det3(e1[0], e2[0], s[0], e1[1], e2[1], s[1], e1[2], e2[2], s[2]);
  const T bn = det3(s[0], e2[0], d[0], s[1], e2[1], d[1], s[2], e2[2], d[2]);
  const T gn = det3(e1[0], s[0], d[0], e1[1], s[1], d[1], e1[2], s[2], d[2]);
  if (kReciprocal) {
    const T inv_a = T(1) / A;  // +-inf on parallel pairs; the tests reject
    t = tn * inv_a;
    beta = bn * inv_a;
    gamma = gn * inv_a;
  } else {
    t = tn / A;
    beta = bn / A;
    gamma = gn / A;
  }
}

// The reference's acceptance predicate (Serial/geometry.h:162).
template <typename T>
__device__ __forceinline__ bool barycentric_pass(T beta, T gamma) {
  return beta > T(0) && gamma > T(0) && beta + gamma < T(1);
}

// The divide variant of cramer_columns for a caller that reads t only
// where the barycentric test passes: beta and gamma first, then the t
// numerator and its division for a pass alone.  Each value it gives is
// the same op for op, so the same bits; t is +inf where nothing passed.
template <typename T>
__device__ __forceinline__ bool cramer_pass_t(const T e1[3], const T e2[3], const T s[3],
                                              const T d[3], T& t) {
  const T A = det3(e1[0], e2[0], d[0], e1[1], e2[1], d[1], e1[2], e2[2], d[2]);
  const T bn = det3(s[0], e2[0], d[0], s[1], e2[1], d[1], s[2], e2[2], d[2]);
  const T gn = det3(e1[0], s[0], d[0], e1[1], s[1], d[1], e1[2], s[2], d[2]);
  const bool passed = barycentric_pass(bn / A, gn / A);
  t = T(INFINITY);
  if (passed) {
    const T tn = det3(e1[0], e2[0], s[0], e1[1], e2[1], s[1], e1[2], e2[2], s[2]);
    t = tn / A;
  }
  return passed;
}
