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
// Design: one thread a cell, x fastest, so a warp holds 32 neighbouring
// cells whose slabs overlap.  The summed-area table (int32, (nz+1) x
// (ny+1) x (nx+1), 8.4 MB at 127x128x128) is built by the wrapper with
// torch.cumsum and read through the read-only cache; it sits in the 50 MB
// L2.  The six extents stay in registers (the direction loop is unrolled),
// and each cell writes its packed 30-bit word (accel/packed.pack_extents)
// once.  A direction whose slab held an occupied cell is not tested again:
// its slab only widens as the other directions grow, so it stays failed,
// and the numpy lock-step's re-tests of it change no bit.
//
// Bound on the H100: integer operations, the slab tests this run's data
// needs (a direction is tested while it is below the cap and has not
// failed) at 42 operations each (OPS_PER_TEST_G in chip_smoke.py: the
// test's clamps, eight table addresses and eight-term sum from scratch)
// against the INT32 rate; the bytes (the occupancy in, a word out) are
// far below it.  Threads of a warp stop growing at different rounds: a
// warp runs as long as its longest-growing cell.  This first version is
// simple and correct, not tuned: sorting cells by expected rounds, or a
// cell a lane of a persistent warp, is left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The occupied cells in the inclusive cell box, clipped as the numpy path
// clips: each low coordinate to [0, n], each high coordinate + 1 to [0, n].
__device__ __forceinline__ int box_count(const int* __restrict__ sat, int nx, int ny,
                                         int nz, int zlo, int zhi, int ylo, int yhi,
                                         int xlo, int xhi) {
  zlo = clampi(zlo, 0, nz);
  zhi = clampi(zhi + 1, 0, nz);
  ylo = clampi(ylo, 0, ny);
  yhi = clampi(yhi + 1, 0, ny);
  xlo = clampi(xlo, 0, nx);
  xhi = clampi(xhi + 1, 0, nx);
  const int sy = nx + 1;
  const int sz = (ny + 1) * sy;
  auto at = [&](int z, int y, int x) { return __ldg(sat + z * sz + y * sy + x); };
  return at(zhi, yhi, xhi) - at(zlo, yhi, xhi) - at(zhi, ylo, xhi) - at(zhi, yhi, xlo)
       + at(zlo, ylo, xhi) + at(zlo, yhi, xlo) + at(zhi, ylo, xlo) - at(zlo, ylo, xlo);
}

__global__ void __launch_bounds__(kThreads)
empty_boxes_kernel(const uint8_t* __restrict__ occ, const int* __restrict__ sat,
                   int nx, int ny, int nz, int cap, int* __restrict__ words,
                   unsigned long long* __restrict__ tests) {
  const int cells = nx * ny * nz;
  const int lin = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lin < cells;
  int e[6] = {0, 0, 0, 0, 0, 0};
  unsigned long long n_tests = 0;
  if (live && !occ[lin]) {
    const int x = lin % nx;
    const int y = (lin / nx) % ny;
    const int z = lin / (nx * ny);
    unsigned failed = 0;  // bit d: direction d's slab held an occupied cell
    bool grew = true;
    while (grew) {
      grew = false;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        if (e[d] >= cap || (failed >> d & 1u)) continue;
        ++n_tests;
        const int xlo = x - e[0], xhi = x + e[1];
        const int ylo = y - e[2], yhi = y + e[3];
        const int zlo = z - e[4], zhi = z + e[5];
        int c;
        switch (d) {
          case 0: c = box_count(sat, nx, ny, nz, zlo, zhi, ylo, yhi, xlo - 1, xlo - 1); break;
          case 1: c = box_count(sat, nx, ny, nz, zlo, zhi, ylo, yhi, xhi + 1, xhi + 1); break;
          case 2: c = box_count(sat, nx, ny, nz, zlo, zhi, ylo - 1, ylo - 1, xlo, xhi); break;
          case 3: c = box_count(sat, nx, ny, nz, zlo, zhi, yhi + 1, yhi + 1, xlo, xhi); break;
          case 4: c = box_count(sat, nx, ny, nz, zlo - 1, zlo - 1, ylo, yhi, xlo, xhi); break;
          default: c = box_count(sat, nx, ny, nz, zhi + 1, zhi + 1, ylo, yhi, xlo, xhi); break;
        }
        if (c == 0) {
          ++e[d];
          grew = true;
        } else {
          failed |= 1u << d;
        }
      }
    }
  }
  if (live) {
    words[lin] = e[0] | (e[1] << 5) | (e[2] << 10) | (e[3] << 15) | (e[4] << 20)
               | (e[5] << 25);
  }
  if (tests != nullptr) {
    for (int off = 16; off > 0; off >>= 1) n_tests += __shfl_down_sync(0xffffffffu, n_tests, off);
    if ((threadIdx.x & 31) == 0 && n_tests) atomicAdd(tests, n_tests);
  }
}

}  // namespace

// occ: (nz, ny, nx) uint8 (torch bool); sat: (nz+1, ny+1, nx+1) int32
// summed-area table with zero low planes.  Writes the packed words
// (nz*ny*nx) int32 [x-@0, x+@5, y-@10, y+@15, z-@20, z+@25], and adds the
// slab tests made to *tests when it is not null.  Returns
// cudaGetLastError() after the launch.
extern "C" int empty_boxes_launch(const uint8_t* occ, const int* sat, int nx, int ny, int nz,
                                  int cap, int* words, unsigned long long* tests,
                                  void* stream) {
  const long long cells = (long long)nx * ny * nz;
  if (cells > 0) {
    const int blocks = (int)((cells + kThreads - 1) / kThreads);
    empty_boxes_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        occ, sat, nx, ny, nz, cap, words, tests);
  }
  return (int)cudaGetLastError();
}
