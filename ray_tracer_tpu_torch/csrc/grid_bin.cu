// Kernel H: the uniform grid's binning, AABB or SAT-exact.
//
// Replaces the binning of the JAX package's C++ host builder
// rtpu_grid_build_v2 (native/raytpu_native.cc:176-314, bound by
// ray_tracer_tpu/accel/native.py:170 build_grid_native), which gives the
// bits of the numpy build ray_tracer_tpu/accel/grid.py:146-206: each
// triangle's AABB in float32, its voxel span by posToVoxel (float32
// (p - lower) * inv_width, numpy's int32 cast, clipped), every (cell,
// triangle) pair of the span tri-major with x outer, y, z inner, and with
// `exact` only the pairs that the SAT test of tri_box_overlap keeps, in
// float64 with numpy's expressions in numpy's order (-fmad=false keeps
// every product and sum rounded on its own).
//
// Design: two kernels.  grid_span_kernel, one thread a triangle, writes its
// span's low corner and size and its candidate count; the wrapper's cumsum
// gives each triangle the position of its first candidate in the
// tri-major list.  grid_bin_kernel, one thread a candidate (balanced however
// large a triangle's span), finds its triangle by a binary search over
// those ends, decodes its cell as numpy does (within // (sy*sz), ...), runs
// the SAT test, and writes the cell key (or, where the test rejects the
// pair, the key n_cells, past every cell) and the triangle at its
// position.  A stable sort of the keys (torch.sort, in the wrapper) then
// orders the pairs by cell with each cell's triangles ascending, as the
// host builder's counting sort does.
//
// Bound on the H100: the SAT test's float64 operations (OPS_PER_SURVIVOR_H
// and OPS_PER_REJECT_H in chip_smoke.py, a candidate: the plane axis and
// the nine edge axes) at the unfused FP64 rate; the bytes (the vertices
// and faces in, the CSR out) are below it.  This first version is
// simple and correct, not tuned: a candidate re-reads its triangle's
// vertices (L1/L2 hits) and the box terms are recomputed per candidate.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

// numpy's minimum and maximum: NaN wins
__device__ __forceinline__ float nminf(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float nmaxf(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ double nmin(double a, double b) {
  return (a != a || b != b) ? __longlong_as_double(0x7ff8000000000000ll) : (a < b ? a : b);
}
__device__ __forceinline__ double nmax(double a, double b) {
  return (a != a || b != b) ? __longlong_as_double(0x7ff8000000000000ll) : (a > b ? a : b);
}

// posToVoxel: numpy's astype(int32) gives INT_MIN for NaN and out-of-range
// values on x86 where a CUDA cast saturates, so it is written out.
__device__ __forceinline__ int to_voxel(float p, float lower, float inv_width, int n) {
  const float v = (p - lower) * inv_width;
  const int i = (v >= -2147483648.0f && v < 2147483648.0f) ? (int)v : INT_MIN;
  const int lo = i > 0 ? i : 0;
  return lo < n - 1 ? lo : n - 1;
}

struct Frame {
  float lower[3], inv_width[3];
  int n[3];
};

__global__ void __launch_bounds__(kThreads)
grid_span_kernel(const float* __restrict__ verts, const int* __restrict__ faces, int n_faces,
                 Frame fr, int* __restrict__ box, long long* __restrict__ count) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_faces) return;
  const float* a = verts + 3 * faces[3 * i];
  const float* b = verts + 3 * faces[3 * i + 1];
  const float* c = verts + 3 * faces[3 * i + 2];
  long long cnt = 1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = nminf(nminf(a[k], b[k]), c[k]);
    const float hi = nmaxf(nmaxf(a[k], b[k]), c[k]);
    const int vmin = to_voxel(lo, fr.lower[k], fr.inv_width[k], fr.n[k]);
    const int vmax = to_voxel(hi, fr.lower[k], fr.inv_width[k], fr.n[k]);
    box[6 * i + k] = vmin;
    box[6 * i + 3 + k] = vmax - vmin + 1;
    cnt *= (long long)(vmax - vmin + 1);
  }
  count[i] = cnt;
}

// True where the axis (ax, ay, az) separates box and triangle
// (tri_box_overlap's sep, term for term).
__device__ __forceinline__ bool sep(double ax, double ay, double az, const double* u0,
                                    const double* u1, const double* u2, const double* h) {
  const double p0 = ax * u0[0] + ay * u0[1] + az * u0[2];
  const double p1 = ax * u1[0] + ay * u1[1] + az * u1[2];
  const double p2 = ax * u2[0] + ay * u2[1] + az * u2[2];
  const double r = h[0] * fabs(ax) + h[1] * fabs(ay) + h[2] * fabs(az);
  const double lo = nmin(nmin(p0, p1), p2);
  const double hi = nmax(nmax(p0, p1), p2);
  return (lo > r) || (hi < -r);
}

__device__ bool tri_box_overlap(const float* a, const float* b, const float* c,
                                const int idx[3], const double lo64[3], const double w64[3]) {
  double u0[3], u1[3], u2[3], h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double fi = (double)idx[k];
    const double box_lo = lo64[k] + fi * w64[k];
    const double box_hi = lo64[k] + (fi + 1.0) * w64[k];
    const double w = w64[k] * 1e-4;
    const double pad = (w != w) ? w : (w > 1e-12 ? w : 1e-12);  // np.maximum
    const double ctr = (box_lo + box_hi) * 0.5;
    h[k] = (box_hi - box_lo) * 0.5 + pad;
    u0[k] = (double)a[k] - ctr;
    u1[k] = (double)b[k] - ctr;
    u2[k] = (double)c[k] - ctr;
  }
  double e0[3], e1[3], e2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e0[k] = u1[k] - u0[k];
    e1[k] = u2[k] - u1[k];
    e2[k] = u0[k] - u2[k];
  }
  // the triangle-plane axis
  if (sep(e0[1] * e1[2] - e0[2] * e1[1], e0[2] * e1[0] - e0[0] * e1[2],
          e0[0] * e1[1] - e0[1] * e1[0], u0, u1, u2, h))
    return false;
  // the 9 edge-cross axes, cross(unit_j, edge) for j in x, y, z
  const double* edges[3] = {e0, e1, e2};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double* e = edges[j];
    const double zero = 0.0;
    if (sep(zero, -e[2], e[1], u0, u1, u2, h)) return false;
    if (sep(e[2], zero, -e[0], u0, u1, u2, h)) return false;
    if (sep(-e[1], e[0], zero, u0, u1, u2, h)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
grid_bin_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                const int* __restrict__ box, const long long* __restrict__ ends, int n_faces,
                long long n_cand, Frame fr, float wx, float wy, float wz, int exact,
                int* __restrict__ keys, int* __restrict__ tri_out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_cand) return;
  // the candidate's triangle: the first i with ends[i] > p
  int lo = 0, hi = n_faces - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > p) hi = mid;
    else lo = mid + 1;
  }
  const int i = lo;
  const long long within = p - (i ? __ldg(ends + i - 1) : 0ll);
  const int* bx = box + 6 * i;
  const long long sy = bx[4], sz = bx[5];
  const long long syz = sy * sz;
  const long long dx = within / syz;
  const long long rem = within % syz;
  const long long dy = rem / sz;
  const long long dz = rem % sz;
  const int idx[3] = {bx[0] + (int)dx, bx[1] + (int)dy, bx[2] + (int)dz};
  const int nx = fr.n[0], ny = fr.n[1], nz = fr.n[2];
  int key = idx[2] * (nx * ny) + idx[1] * nx + idx[0];  // z-major
  if (exact) {
    const double lo64[3] = {(double)fr.lower[0], (double)fr.lower[1], (double)fr.lower[2]};
    const double w64[3] = {(double)wx, (double)wy, (double)wz};
    const float* a = verts + 3 * faces[3 * i];
    const float* b = verts + 3 * faces[3 * i + 1];
    const float* c = verts + 3 * faces[3 * i + 2];
    if (!tri_box_overlap(a, b, c, idx, lo64, w64)) key = nx * ny * nz;
  }
  keys[p] = key;
  tri_out[p] = i;
}

Frame make_frame(float lx, float ly, float lz, float ix, float iy, float iz, int nx, int ny,
                 int nz) {
  Frame fr;
  fr.lower[0] = lx; fr.lower[1] = ly; fr.lower[2] = lz;
  fr.inv_width[0] = ix; fr.inv_width[1] = iy; fr.inv_width[2] = iz;
  fr.n[0] = nx; fr.n[1] = ny; fr.n[2] = nz;
  return fr;
}

}  // namespace

// verts (V, 3) f32, faces (F, 3) int32 (checked in range by the caller).
// Writes box (F, 6) int32 (the span's low voxel xyz, its size xyz) and
// count (F,) int64 (its candidates).  Returns cudaGetLastError().
extern "C" int grid_span_launch(const float* verts, const int* faces, int n_faces, float lx,
                                float ly, float lz, float ix, float iy, float iz, int nx,
                                int ny, int nz, int* box, long long* count, void* stream) {
  if (n_faces > 0) {
    const int blocks = (n_faces + kThreads - 1) / kThreads;
    grid_span_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        verts, faces, n_faces, make_frame(lx, ly, lz, ix, iy, iz, nx, ny, nz), box, count);
  }
  return (int)cudaGetLastError();
}

// ends (F,) int64: the inclusive cumsum of count.  Writes keys (n_cand,)
// int32, each candidate's z-major cell or nx*ny*nz where `exact` and the
// SAT test rejects it, and tri (n_cand,) int32, its triangle.  Returns
// cudaGetLastError().
extern "C" int grid_bin_launch(const float* verts, const int* faces, const int* box,
                               const long long* ends, int n_faces, long long n_cand, float lx,
                               float ly, float lz, float wx, float wy, float wz, int nx, int ny,
                               int nz, int exact, int* keys, int* tri, void* stream) {
  if (n_cand > 0) {
    const long long blocks = (n_cand + kThreads - 1) / kThreads;
    // the bin kernel reads no inv_width: the span kernel took posToVoxel
    grid_bin_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        verts, faces, box, ends, n_faces, n_cand,
        make_frame(lx, ly, lz, 0.f, 0.f, 0.f, nx, ny, nz), wx, wy, wz, exact, keys, tri);
  }
  return (int)cudaGetLastError();
}
