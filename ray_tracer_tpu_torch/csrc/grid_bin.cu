// Kernel H: the uniform grid's binning, AABB or SAT-exact.
//
// Replaces the binning of the JAX package's C++ host builder
// rtpu_grid_build_v2 (native/raytpu_native.cc:176-314, bound by
// ray_tracer_tpu/accel/native.py:170 build_grid_native), which gives the
// bits of the numpy build ray_tracer_tpu/accel/grid.py:307-373
// (_build_csr_numpy, with tri_box_overlap at :120): each triangle's AABB in
// float32, its voxel span by posToVoxel (float32 (p - lower) * inv_width,
// numpy's int32 cast, clipped), every (cell, triangle) pair of the span
// tri-major with x outer, y, z inner, and with `exact` only the pairs that
// the SAT test keeps, in float64 with numpy's expressions in numpy's order
// (-fmad=false keeps every product and sum rounded on its own); each
// cell's triangles in ascending order.
//
// Design: a counting scatter.  grid_span_kernel, a thread a triangle,
// checks its face indices (a device flag, no read out of range) and writes
// its span's low corner and size and its candidate count; the wrapper's
// scan gives each triangle the end of its candidates in the tri-major
// list, and one host read takes the candidate count with the flag.
// grid_count_kernel, a thread a candidate (balanced however large a
// triangle's span): a block finds its first triangle once (a warp-wide
// 32-way search of the ends in L2) and stages the ends, spans and vertices
// of the at most kThreads triangles its candidates cover in shared memory
// (plain loads); each thread finds its triangle there, decodes its cell as
// numpy does (within // (sy*sz), ...), runs the SAT test, and for a kept
// pair adds one to its cell's int64 count, keeping the count's old value as
// its slot.  The wrapper's scan of the counts is cell_start.
// grid_scatter_kernel puts each kept pair's triangle at its cell's start
// plus its slot, in whatever order the atomics took; a triangle enters a
// cell at most once, so sorting each cell's segment gives the stable
// sort's order.  grid_cell_sort_kernel: a warp a block of 32 cells, each
// occupied cell of at most 32 triangles by ranks over shuffles (a lane an
// element); larger cells go on a list that grid_big_sort_kernel, a block a
// cell, sorts (bitonic in shared memory up to kBlockSort, ranks past it).
// The second host read is nnz.  Measured on the card and lost (PERF.md): a
// thread a cell sorting by insertion in device memory (its dependent
// reads cost 0.22 ms on nefertiti), and a warp for each cell of more than
// 32 within its own block of 32 cells (large cells lie side by side, so one
// warp sorted many: 0.09 ms).
//
// Bound on the H100: the SAT test's float64 operations (OPS_PER_SURVIVOR_H
// and OPS_PER_REJECT_H in chip_smoke.py, a candidate: the plane axis and
// the nine edge axes) at the unfused FP64 rate on SAT-exact grids; the
// bytes (the vertices and faces in, the counts written and read, the CSR
// out) on AABB grids.  The wrapper's host work (its launches and two
// reads) lies outside the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockSort = 4096;  // most triangles a block sorts in shared memory

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
  float lower[3], inv_width[3], width[3];
  int n[3];
};

__global__ void __launch_bounds__(kThreads)
grid_span_kernel(const float* __restrict__ verts, int n_verts, const int* __restrict__ faces,
                 int n_faces, Frame fr, int* __restrict__ box, long long* __restrict__ count,
                 long long* __restrict__ bad) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_faces) return;
  const int f0 = faces[3 * i], f1 = faces[3 * i + 1], f2 = faces[3 * i + 2];
  if (f0 < 0 || f0 >= n_verts || f1 < 0 || f1 >= n_verts || f2 < 0 || f2 >= n_verts) {
    *bad = 1;
    count[i] = 0;
    return;
  }
  const float* a = verts + 3 * f0;
  const float* b = verts + 3 * f1;
  const float* c = verts + 3 * f2;
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

// v: the triangle's nine floats [v0 v1 v2]
__device__ bool tri_box_overlap(const float* v, const int idx[3], const Frame& fr) {
  double u0[3], u1[3], u2[3], h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double lo64 = (double)fr.lower[k];
    const double w64 = (double)fr.width[k];
    const double fi = (double)idx[k];
    const double box_lo = lo64 + fi * w64;
    const double box_hi = lo64 + (fi + 1.0) * w64;
    const double w = w64 * 1e-4;
    const double pad = (w != w) ? w : (w > 1e-12 ? w : 1e-12);  // np.maximum
    const double ctr = (box_lo + box_hi) * 0.5;
    h[k] = (box_hi - box_lo) * 0.5 + pad;
    u0[k] = (double)v[k] - ctr;
    u1[k] = (double)v[3 + k] - ctr;
    u2[k] = (double)v[6 + k] - ctr;
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

// One thread a candidate p (tri-major).  A kept pair adds one to its
// cell's count; key[p] is its cell (-1 where the SAT test rejects it),
// slot[p] the count's old value, tri[p] its triangle.
__global__ void __launch_bounds__(kThreads)
grid_count_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                  const int* __restrict__ box, const long long* __restrict__ ends, int n_faces,
                  long long n_cand, Frame fr, int exact, unsigned long long* __restrict__ counts,
                  int* __restrict__ key, int* __restrict__ slot, int* __restrict__ tri) {
  __shared__ long long s_end[kThreads];  // ends of triangles i0 .. i0 + kThreads - 1
  __shared__ int s_box[kThreads * 6];
  __shared__ float s_v[kThreads * 9];
  __shared__ int s_i0;
  __shared__ long long s_start0;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const long long p_last = (p0 + kThreads < n_cand ? p0 + kThreads : n_cand) - 1;
  const int t = threadIdx.x;
  if (t < 32) {
    // the first triangle with ends > p0: each round the warp probes 32
    // points of [lo, hi] and keeps the part before the first that passes
    int lo = 0, hi = n_faces - 1;
    while (lo < hi) {
      const int q = lo + (int)((long long)(hi - lo) * (t + 1) / 32);
      const unsigned pass = __ballot_sync(kFull, __ldg(ends + q) > p0);
      const int first = __ffs(pass) - 1;  // lane 31 probes hi, which passes
      const int q_first = __shfl_sync(kFull, q, first);
      const int q_before = __shfl_sync(kFull, q, first > 0 ? first - 1 : 0);
      lo = first > 0 ? q_before + 1 : lo;
      hi = q_first;
    }
    if (t == 0) {
      s_i0 = lo;
      s_start0 = lo > 0 ? __ldg(ends + lo - 1) : 0ll;
    }
  }
  __syncthreads();
  const int i0 = s_i0;
  {
    // stage the triangles whose candidates start within the block
    const int i = i0 + t;
    s_end[t] = LLONG_MAX;
    if (i < n_faces) {
      const long long start = t == 0 ? s_start0 : __ldg(ends + i - 1);
      if (start <= p_last) {
        s_end[t] = __ldg(ends + i);
#pragma unroll
        for (int k = 0; k < 6; ++k) s_box[6 * t + k] = box[6 * i + k];
        if (exact) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float* v = verts + 3 * faces[3 * i + j];
#pragma unroll
            for (int k = 0; k < 3; ++k) s_v[9 * t + 3 * j + k] = v[k];
          }
        }
      }
    }
  }
  __syncthreads();
  const long long p = p0 + t;
  if (p >= n_cand) return;
  int lo = 0, hi = kThreads - 1;  // the first staged triangle with ends > p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] > p) hi = mid;
    else lo = mid + 1;
  }
  const int j = lo;
  const long long within = p - (j ? s_end[j - 1] : s_start0);
  const int* bx = s_box + 6 * j;
  const long long sy = bx[4], sz = bx[5];
  const long long syz = sy * sz;
  const long long dx = within / syz;
  const long long rem = within % syz;
  const long long dy = rem / sz;
  const long long dz = rem % sz;
  const int idx[3] = {bx[0] + (int)dx, bx[1] + (int)dy, bx[2] + (int)dz};
  const int nx = fr.n[0], ny = fr.n[1];
  const int cell = idx[2] * (nx * ny) + idx[1] * nx + idx[0];  // z-major
  if (exact && !tri_box_overlap(s_v + 9 * j, idx, fr)) {
    key[p] = -1;
    return;
  }
  key[p] = cell;
  slot[p] = (int)atomicAdd(counts + cell, 1ull);
  tri[p] = i0 + j;
}

__global__ void __launch_bounds__(kThreads)
grid_scatter_kernel(const int* __restrict__ key, const int* __restrict__ slot,
                    const int* __restrict__ tri, const long long* __restrict__ cell_start,
                    long long n_cand, int* __restrict__ buf) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_cand) return;
  const int c = key[p];
  if (c >= 0) buf[cell_start[c] + slot[p]] = tri[p];
}

// Each cell of at most 32 triangles from buf into out, ascending: a warp a
// block of 32 cells, sorting each occupied one in turn by ranks over
// shuffles (a lane an element).  Larger cells go on a list (big, its
// length in ctr[0]) for grid_big_sort_kernel.
__global__ void __launch_bounds__(kThreads)
grid_cell_sort_kernel(const long long* __restrict__ cell_start, int n_cells,
                      const int* __restrict__ buf, int* __restrict__ out, int* __restrict__ big,
                      int* ctr) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long s = 0;
  int n = 0;
  if (c < n_cells) {
    s = cell_start[c];
    n = (int)(cell_start[c + 1] - s);
  }
  for (unsigned todo = __ballot_sync(kFull, n > 0 && n <= 32); todo; todo &= todo - 1) {
    const int b = __ffs(todo) - 1;
    const long long bs = __shfl_sync(kFull, s, b);
    const int bn = __shfl_sync(kFull, n, b);
    const int v = lane < bn ? buf[bs + lane] : INT_MAX;
    int r = 0;
    for (int k = 0; k < bn; ++k) r += __shfl_sync(kFull, v, k) < v ? 1 : 0;
    if (lane < bn) out[bs + r] = v;
  }
  const unsigned m = __ballot_sync(kFull, n > 32);
  if (m) {
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(ctr, __popc(m));
    base = __shfl_sync(kFull, base, leader);
    if (n > 32) big[base + __popc(m & ((1u << lane) - 1u))] = c;
  }
}

// The cells of more than 32 triangles, a block a cell taken from the list
// (ctr[1] its head): a bitonic sort in shared memory up to kBlockSort,
// past it ranks over the segment.  Persistent.
__global__ void __launch_bounds__(kThreads)
grid_big_sort_kernel(const long long* __restrict__ cell_start, const int* __restrict__ buf,
                     int* __restrict__ out, const int* __restrict__ big, int* ctr) {
  __shared__ int sm[kBlockSort];
  __shared__ int s_q;
  const int t = threadIdx.x;
  const int n_big = ctr[0];
  for (;;) {
    if (t == 0) s_q = atomicAdd(ctr + 1, 1);
    __syncthreads();
    const int q = s_q;
    if (q >= n_big) break;
    const int c = big[q];
    const long long bs = cell_start[c];
    const int bn = (int)(cell_start[c + 1] - bs);
    if (bn <= kBlockSort) {
      int len = 64;
      while (len < bn) len <<= 1;
      for (int i = t; i < len; i += kThreads) sm[i] = i < bn ? buf[bs + i] : INT_MAX;
      __syncthreads();
      for (int k = 2; k <= len; k <<= 1) {
        for (int jj = k >> 1; jj > 0; jj >>= 1) {
          for (int i = t; i < len; i += kThreads) {
            const int ij = i ^ jj;
            if (ij > i) {
              const int a = sm[i], v = sm[ij];
              if ((a > v) == ((i & k) == 0)) {
                sm[i] = v;
                sm[ij] = a;
              }
            }
          }
          __syncthreads();
        }
      }
      for (int i = t; i < bn; i += kThreads) out[bs + i] = sm[i];
    } else {
      for (int i = t; i < bn; i += kThreads) {  // ranks: the triangles are unique
        const int v = buf[bs + i];
        int r = 0;
        for (int k = 0; k < bn; ++k) r += buf[bs + k] < v ? 1 : 0;
        out[bs + r] = v;
      }
    }
    __syncthreads();  // sm and s_q are free for the next cell
  }
}

Frame make_frame(float lx, float ly, float lz, float ix, float iy, float iz, float wx, float wy,
                 float wz, int nx, int ny, int nz) {
  Frame fr;
  fr.lower[0] = lx; fr.lower[1] = ly; fr.lower[2] = lz;
  fr.inv_width[0] = ix; fr.inv_width[1] = iy; fr.inv_width[2] = iz;
  fr.width[0] = wx; fr.width[1] = wy; fr.width[2] = wz;
  fr.n[0] = nx; fr.n[1] = ny; fr.n[2] = nz;
  return fr;
}

}  // namespace

// verts (V, 3) f32, faces (F, 3) int32.  Writes box (F, 6) int32 (the
// span's low voxel xyz, its size xyz) and count (F,) int64 (its
// candidates); a face index outside [0, V) sets *bad (zeroed by the
// caller) and gives its triangle no candidate.  Returns cudaGetLastError().
extern "C" int grid_span_launch(const float* verts, int n_verts, const int* faces, int n_faces,
                                float lx, float ly, float lz, float ix, float iy, float iz,
                                int nx, int ny, int nz, int* box, long long* count,
                                long long* bad, void* stream) {
  if (n_faces > 0) {
    const int blocks = (n_faces + kThreads - 1) / kThreads;
    grid_span_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        verts, n_verts, faces, n_faces,
        make_frame(lx, ly, lz, ix, iy, iz, 0.f, 0.f, 0.f, nx, ny, nz), box, count, bad);
  }
  return (int)cudaGetLastError();
}

// ends (F,) int64: the inclusive cumsum of count, every count >= 1.
// counts (nx*ny*nz,) int64 zeroed by the caller gets each cell's kept
// pairs; key, slot, tri (n_cand,) int32 as grid_count_kernel writes them.
// Returns cudaGetLastError().
extern "C" int grid_count_launch(const float* verts, const int* faces, const int* box,
                                 const long long* ends, int n_faces, long long n_cand, float lx,
                                 float ly, float lz, float wx, float wy, float wz, int nx,
                                 int ny, int nz, int exact, unsigned long long* counts, int* key,
                                 int* slot, int* tri, void* stream) {
  if (n_cand > 0) {
    const long long blocks = (n_cand + kThreads - 1) / kThreads;
    // the count kernel reads no inv_width: the span kernel took posToVoxel
    grid_count_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        verts, faces, box, ends, n_faces, n_cand,
        make_frame(lx, ly, lz, 0.f, 0.f, 0.f, wx, wy, wz, nx, ny, nz), exact, counts, key, slot,
        tri);
  }
  return (int)cudaGetLastError();
}

// cell_start (n_cells + 1,) int64, the exclusive scan of the counts.
// Writes each kept pair's triangle into buf (n_cand,) int32 scratch at its
// cell's start plus its slot, then out[cell_start[c] ..] each cell's
// triangles ascending; key and slot, read by the scatter, then hold the
// list of large cells and its counters.  Returns the first CUDA error.
extern "C" int grid_place_launch(int* key, int* slot, const int* tri,
                                 const long long* cell_start, long long n_cand, int n_cells,
                                 int* buf, int* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_cand == 0) return 0;
  const long long blocks = (n_cand + kThreads - 1) / kThreads;
  grid_scatter_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(key, slot, tri, cell_start, n_cand,
                                                           buf);
  cudaError_t err = cudaMemsetAsync(slot, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  grid_cell_sort_kernel<<<(n_cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      cell_start, n_cells, buf, out, key, slot);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_big_sort_kernel, kThreads,
                                                        0);
  }
  if (err != cudaSuccess) return (int)err;
  grid_big_sort_kernel<<<sms * (per_sm > 0 ? per_sm : 1), kThreads, 0, s>>>(cell_start, buf, out,
                                                                            key, slot);
  return (int)cudaGetLastError();
}
