// Kernel G: the greedy maximal empty box of every empty cell of a grid.
//
// Replaces the JAX package's C++ host builder rtpu_empty_boxes
// (native/raytpu_native.cc:395-467, bound by
// ray_tracer_tpu/accel/native.py:151 empty_boxes_native), which gives the
// bits of the numpy growth ray_tracer_tpu/accel/packed.py:188-232: every
// round each direction, in the order x-, x+, y-, y+, z-, z+, tries to grow
// by one cell while the slab it adds holds no occupied cell (one box count
// on a summed-area table, clipped, so outside the grid counts as empty),
// up to `cap` cells a direction; occupied cells get zeros.  A cell's
// growth reads only the occupancy and its own extents, so a thread's own
// loop gives the numpy lock-step's bits.
//
// The jump.  Let B_j be the cell's box with every direction that has not
// failed grown by j (at most to the cap).  If B_j holds no occupied cell,
// the next j greedy rounds all succeed in every direction still below the
// cap: each slab they test lies inside B_j.  Box counts only grow with j,
// so a binary search over j on the same table finds the largest such j,
// and the greedy loop goes on from there.  From extents all 0 this is the
// largest empty cube around the cell (its Chebyshev radius); after a round
// it is the same search over the directions still open.  A round after a
// jump that stopped short of the cap fails somewhere (B_j+1 holds an
// occupied cell), so a cell makes at most seven rounds.  The words are the
// greedy loop's bits, and `tests` counts the slab tests the greedy loop
// makes (a jump by j adds one a round for each direction it grows).  On
// nefertiti's 127x128x128 grid the kernel makes 51.9 million box counts
// where the greedy loop makes 243.7 million slab tests.
//
// Bound on the H100: the box counts, eight gathered 4-byte reads and about
// 45 integer operations each (OPS_PER_PROBE_G and OPS_PER_TEST_G in
// chip_smoke.py) against the INT32 rate; the bytes (the occupancy in, a
// word out) are below it.  What holds the kernel back is how well a warp's
// gathers coalesce, and its lanes waiting on one another.
//
// Design.  The table, int32 ((nz+1) x (ny+1) x (nx+1), 8.4 MB at
// 127x128x128, L2-resident, read through the read-only path), by two
// kernels of its own: a block a z plane (each warp's rows by a shuffle scan
// along x, then the block's columns along y), then a thread a (y, x)
// column along z.  Then one kernel, a thread a cell, x fastest, so that a
// warp holds neighbouring cells whose boxes share cache lines: every lane
// makes the same kind of box count at the same step (the cube's probes
// together; then in each round the slab of direction d at step d, in each
// search a probe a step), so the warp's gathers stay close.  Measured on
// the card and lost (PERF.md): a queue of the cells left after the cube
// search, served by a persistent wave that refills idle lanes as kernel E
// does (at 8, 16, 24 or 32 idle lanes, warp-local pools of 32 or 256),
// with each lane free to run its own phase or the warp in lock-step, or in
// six launches with the queue compacted between them; all of them gave a
// warp cells far apart, and their gathers cost more than the lanes of
// occupied or finished cells that now wait.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Table {
  const int* sat;
  int nx, ny, nz, sy, sz;
};

struct Counters {
  unsigned long long* tests;    // (1,) the greedy loop's slab tests
  unsigned long long* queries;  // (2,) the probes and slab tests made
};

// The occupied cells in the inclusive cell box, clipped as the numpy path
// clips: each low coordinate to [0, n], each high coordinate + 1 to [0, n].
__device__ __forceinline__ int box_count(const Table& t, int zlo, int zhi, int ylo, int yhi,
                                         int xlo, int xhi) {
  zlo = clampi(zlo, 0, t.nz);
  zhi = clampi(zhi + 1, 0, t.nz);
  ylo = clampi(ylo, 0, t.ny);
  yhi = clampi(yhi + 1, 0, t.ny);
  xlo = clampi(xlo, 0, t.nx);
  xhi = clampi(xhi + 1, 0, t.nx);
  auto at = [&](int z, int y, int x) { return __ldg(t.sat + z * t.sz + y * t.sy + x); };
  return at(zhi, yhi, xhi) - at(zlo, yhi, xhi) - at(zhi, ylo, xhi) - at(zhi, yhi, xlo)
       + at(zlo, ylo, xhi) + at(zlo, yhi, xlo) + at(zhi, ylo, xlo) - at(zlo, ylo, xlo);
}

__device__ __forceinline__ int pack(const int e[6]) {
  return e[0] | (e[1] << 5) | (e[2] << 10) | (e[3] << 15) | (e[4] << 20) | (e[5] << 25);
}

// Plane p of the table: zero for p = 0, else the 2-D prefix sums of
// occupancy plane p - 1 with a zero row and column in front.
__global__ void __launch_bounds__(kThreads)
sat_plane_kernel(const uint8_t* __restrict__ occ, int nx, int ny, int* __restrict__ sat) {
  const int p = blockIdx.x;
  const int sy = nx + 1;
  int* plane = sat + (long long)p * (ny + 1) * sy;
  const int lane = threadIdx.x & 31;
  for (int yy = threadIdx.x >> 5; yy <= ny; yy += kThreads / 32) {
    int carry = 0;
    for (int x0 = 0; x0 <= nx; x0 += 32) {
      const int xi = x0 + lane;
      int v = (p > 0 && yy > 0 && xi > 0 && xi <= nx)
                  ? occ[((long long)(p - 1) * ny + (yy - 1)) * nx + (xi - 1)]
                  : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (xi <= nx) plane[yy * sy + xi] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();  // the block's row sums are visible to its threads
  for (int xi = threadIdx.x; xi <= nx; xi += kThreads) {
    int s = 0;
    for (int y0 = 1; y0 <= ny; y0 += 8) {
      int v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = y0 + k <= ny ? plane[(y0 + k) * sy + xi] : 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s += v[k];
        if (y0 + k <= ny) plane[(y0 + k) * sy + xi] = s;
      }
    }
  }
}

// The sums along z, a thread a (y, x) column of the table.
__global__ void __launch_bounds__(kThreads)
sat_depth_kernel(int nx, int ny, int nz, int* __restrict__ sat) {
  const int plane = (ny + 1) * (nx + 1);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= plane) return;
  int* col = sat + i;
  int s = 0;
  for (int z0 = 1; z0 <= nz; z0 += 8) {
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = z0 + k <= nz ? col[(long long)(z0 + k) * plane] : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s += v[k];
      if (z0 + k <= nz) col[(long long)(z0 + k) * plane] = s;
    }
  }
}

__device__ __forceinline__ void fold_counters(const Counters& c, unsigned long long greedy,
                                              unsigned long long probes,
                                              unsigned long long made) {
  const bool lead = (threadIdx.x & 31) == 0;
  if (c.tests != nullptr) {
    for (int off = 16; off > 0; off >>= 1) greedy += __shfl_down_sync(kFull, greedy, off);
    if (lead && greedy) atomicAdd(c.tests, greedy);
  }
  if (c.queries != nullptr) {
    for (int off = 16; off > 0; off >>= 1) {
      probes += __shfl_down_sync(kFull, probes, off);
      made += __shfl_down_sync(kFull, made, off);
    }
    if (lead && probes) atomicAdd(c.queries, probes);
    if (lead && made) atomicAdd(c.queries + 1, made);
  }
}

// A thread a cell, x fastest.  The cube search, then iterations of a round
// and a search with its jump, the warp's lanes taking each step together
// (the same direction, or a probe) until every cell of the warp is final;
// occupied cells and cells that are final wait in their lanes.
__global__ void __launch_bounds__(kThreads)
empty_boxes_kernel(const uint8_t* __restrict__ occ, Table t, int cap, int* __restrict__ words,
                   Counters c) {
  const int cells = t.nx * t.ny * t.nz;
  const int lin = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lin < cells;
  bool active = live && !occ[lin];
  const int x = lin % t.nx;
  const int y = (lin / t.nx) % t.ny;
  const int z = lin / (t.nx * t.ny);
  int e[6] = {0, 0, 0, 0, 0, 0};
  unsigned failed = 0;
  unsigned greedy = 0, probes = 0, made = 0;
  int lo = 0, hi = active ? cap : 0;
  while (__ballot_sync(kFull, lo < hi)) {  // the cube
    if (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      ++probes;
      if (box_count(t, z - mid, z + mid, y - mid, y + mid, x - mid, x + mid) == 0) lo = mid;
      else hi = mid - 1;
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < 6; ++j) e[j] = lo;
    greedy = 6u * lo;
    active = lo < cap;
  }
  while (__ballot_sync(kFull, active)) {
    bool grew = false;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      if (active && !(failed >> d & 1u) && e[d] < cap) {
        int xlo = x - e[0], xhi = x + e[1];
        int ylo = y - e[2], yhi = y + e[3];
        int zlo = z - e[4], zhi = z + e[5];
        if (d == 0) xlo = xhi = xlo - 1;
        else if (d == 1) xlo = xhi = xhi + 1;
        else if (d == 2) ylo = yhi = ylo - 1;
        else if (d == 3) ylo = yhi = yhi + 1;
        else if (d == 4) zlo = zhi = zlo - 1;
        else zlo = zhi = zhi + 1;
        ++made;
        ++greedy;
        if (box_count(t, zlo, zhi, ylo, yhi, xlo, xhi) == 0) {
          ++e[d];
          grew = true;
        } else {
          failed |= 1u << d;
        }
      }
    }
    int low = cap;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (!(failed >> j & 1u) && e[j] < low) low = e[j];
    }
    if (!grew || low == cap) active = false;
    lo = 0;
    hi = active ? cap - low : 0;
    while (__ballot_sync(kFull, lo < hi)) {
      if (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        int g[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int grown = e[j] + mid < cap ? e[j] + mid : cap;
          g[j] = (failed >> j & 1u) ? e[j] : grown;
        }
        ++probes;
        if (box_count(t, z - g[4], z + g[5], y - g[2], y + g[3], x - g[0], x + g[1]) == 0) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
    }
    if (active) {
      bool open = false;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (!(failed >> j & 1u)) {
          const int a = lo < cap - e[j] ? lo : cap - e[j];
          greedy += a;
          e[j] += a;
          open = open || e[j] < cap;
        }
      }
      active = open;
    }
  }
  if (live) words[lin] = pack(e);
  fold_counters(c, greedy, probes, made);
}

}  // namespace

// occ: (nz, ny, nx) uint8 (torch bool); sat: (nz+1, ny+1, nx+1) int32
// scratch for the summed-area table.  Writes the packed words (nz*ny*nx)
// int32 [x-@0, x+@5, y-@10, y+@15, z-@20, z+@25]; adds the greedy loop's
// slab tests to *tests, and the probes and slab tests made to queries[0]
// and queries[1], when they are not null.  Returns cudaGetLastError().
extern "C" int empty_boxes_launch(const uint8_t* occ, int* sat, int nx, int ny, int nz, int cap,
                                  int* words, unsigned long long* tests,
                                  unsigned long long* queries, void* stream) {
  const long long cells = (long long)nx * ny * nz;
  if (cells == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  sat_plane_kernel<<<nz + 1, kThreads, 0, s>>>(occ, nx, ny, sat);
  const int plane = (ny + 1) * (nx + 1);
  sat_depth_kernel<<<(plane + kThreads - 1) / kThreads, kThreads, 0, s>>>(nx, ny, nz, sat);
  const Table t{sat, nx, ny, nz, nx + 1, plane};
  empty_boxes_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      occ, t, cap, words, Counters{tests, queries});
  return (int)cudaGetLastError();
}
