// take_grad: the backward of core/vecmath.take (x.index_select(0, index)).
// out (N, C), zero-filled by the wrapper, gets g (R, C) added row by row at
// index (R,): out[index[r]] += g[r], index_add_'s sum.
//
// Replaces no TPU kernel: the JAX package leaves this scatter-add to XLA
// (the transpose of jnp.take under jax.grad).  It was added because
// PyTorch's index_add_ issues one atomic a row and column, and the fit's
// rows pile onto a few addresses: every lane of a one-material scene adds
// into row 0 of the material table, and every missed lane gathers triangle
// 0, so its zero gradient adds into that row.  Atomics on one address
// serialise in L2; at 2048^2 the fit's eight scatters took 37.6 ms a step.
//
// Bound on the H100: device-memory bytes.  g and index are read once and out
// is written once (the zero fill and the atomics' rows): at the fit's shapes
// about 0.44 GB a step, 0.13 ms at 3.35 TB/s; the adds are a few per byte.
//
// Design: a thread owns k consecutive rows, a warp 32 k.  The warp stages its
// rows' values in shared memory with coalesced loads; each lane's slab of k
// rows is padded to an odd number of words, so the lanes' reads fall in
// distinct banks.  Each lane walks its rows and sums every run of equal
// consecutive indices in registers, one sum a column; a run that begins and
// ends inside its rows costs one atomicAdd a column.  A lane's first and last
// runs may continue in its neighbours' rows: a segmented inclusive scan over
// the warp's lanes (shuffles, keyed on the index) joins them, and the lane in
// which a joined run ends issues its atomics.  A run of any length thus costs
// at most one atomic a column for each warp it crosses, where index_add_
// spends one a row.  Indices with no runs cost one atomic a row and column,
// as index_add_'s do, but a warp's atomics then fall in 32 rows where
// index_add_'s fall in about three: on random indices at 4,194,304 x 10 rows
// the kernel took 0.544 ms against index_add_'s 0.309 on an H100 (700 W).
// Missed lanes are ordinary runs of index 0: zeros are summed, not skipped.
// The result is index_add_'s sum taken in another order, as index_add_'s own
// atomics take it in an order that changes from call to call.
//
// k is 16 (8 for slabs of 8 columns or more), halved on the host while the
// grid would hold fewer than kMinWarps warps, so that short inputs still
// spread over the 132 SMs.  Columns: C = 1, 3 and 10 (the fit's widths) are
// instantiated whole; any other C runs in tiles of 4 columns, a tile a grid
// row.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // warps a block
constexpr long long kMinWarps = 1056;  // 8 a streaming multiprocessor
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int CT>
__global__ void __launch_bounds__(32 * kWarps)
take_grad_kernel(const T* __restrict__ g, const long long* __restrict__ index, long long rows,
                 int cols, int kshift, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int k = 1 << kshift;
  const int stride = (k * CT) | 1;  // a lane's slab, odd in words
  T* stage = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * 32 * stride;
  const long long base = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32 * k;
  if (base >= rows) return;  // the whole warp
  const int c0 = blockIdx.y * CT;
  const int n_warp = (int)min((long long)(32 * k), rows - base);

  // stage the warp's rows: the tile's columns of row base + r
  for (int e = lane; e < n_warp * CT; e += 32) {
    const int r = e / CT;
    const int c = e - r * CT;
    const int owner = r >> kshift;
    stage[owner * stride + (r - owner * k) * CT + c] =
        c0 + c < cols ? g[(base + r) * cols + c0 + c] : T(0);
  }
  __syncwarp();

  // this lane's rows: each inner run flushed, the first kept in head, the
  // last in acc (the same run, `single`, when the rows hold one index)
  const int n = max(0, min(k, n_warp - lane * k));
  const T* mine = stage + lane * stride;
  long long first = -1, last = -1;  // -1: the lane has no rows
  bool single = true;
  T head[CT], acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) head[c] = acc[c] = T(0);
  if (n > 0) {
    const long long* ix = index + base + lane * k;
    long long cur = ix[0];
    first = cur;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] = mine[c];
    for (int j = 1; j < n; ++j) {
      const long long key = ix[j];
      if (key != cur) {
        if (single) {
#pragma unroll
          for (int c = 0; c < CT; ++c) head[c] = acc[c];
          single = false;
        } else {
#pragma unroll
          for (int c = 0; c < CT; ++c)
            if (c0 + c < cols) atomicAdd(out + cur * cols + c0 + c, acc[c]);
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[c] = mine[j * CT + c];
        cur = key;
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[c] += mine[j * CT + c];
      }
    }
    last = cur;
  }

  // join across lanes: `joins` when this lane's first run continues the
  // previous lane's last; the lane's last run is a segment of the scan that
  // starts here unless the whole lane continues the previous one
  const long long prev_last = __shfl_up_sync(kFull, last, 1);
  const bool joins = lane > 0 && n > 0 && first == prev_last;
  const bool next_joins = __shfl_down_sync(kFull, (int)joins, 1) && lane < 31;
  bool seg = !(single && joins);
  unsigned add = 0;  // bit s: take the partial of lane - 2^s at step s
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const bool other = __shfl_up_sync(kFull, (int)seg, 1 << s);
    if (lane >= (1 << s)) {
      if (!seg) add |= 1u << s;
      seg = seg || other;
    }
  }
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    T v = acc[c];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const T o = __shfl_up_sync(kFull, v, 1 << s);
      if (add >> s & 1u) v = o + v;
    }
    const T in = __shfl_up_sync(kFull, v, 1);  // the run flowing into this lane
    if (c0 + c < cols && n > 0) {
      if (!single) atomicAdd(out + first * cols + c0 + c, joins ? in + head[c] : head[c]);
      if (!next_joins) atomicAdd(out + last * cols + c0 + c, v);
    }
  }
}

template <typename T, int CT>
int launch(const void* g, const void* index, long long rows, int cols, void* out,
           cudaStream_t stream) {
  int kshift = CT >= 8 ? 3 : 4;
  while (kshift > 0 && (rows + (32LL << kshift) - 1) / (32LL << kshift) < kMinWarps) --kshift;
  const int k = 1 << kshift;
  const long long warps = (rows + 32LL * k - 1) / (32LL * k);
  const size_t smem = (size_t)kWarps * 32 * ((k * CT) | 1) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        take_grad_kernel<T, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps), (unsigned)((cols + CT - 1) / CT));
  take_grad_kernel<T, CT><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const long long*>(index), rows, cols, kshift,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cols(const void* g, const void* index, long long rows, int cols, void* out,
                cudaStream_t stream) {
  switch (cols) {
    case 1: return launch<T, 1>(g, index, rows, cols, out, stream);
    case 3: return launch<T, 3>(g, index, rows, cols, out, stream);
    case 10: return launch<T, 10>(g, index, rows, cols, out, stream);
    default: return launch<T, 4>(g, index, rows, cols, out, stream);
  }
}

}  // namespace

// g (rows, cols) float32 (value_bytes 4) or float64 (8), contiguous; index
// (rows,) int64, each in [0, N); out (N, cols) of g's type, zero-filled,
// gets the sums.  Returns a cudaError_t: 1 (cudaErrorInvalidValue) for a
// type it does not take, else cudaGetLastError() after the launch.
extern "C" int take_grad_launch(const void* g, const void* index, long long rows, int cols,
                                int value_bytes, void* out, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (value_bytes == 4) return launch_cols<float>(g, index, rows, cols, out, s);
  if (value_bytes == 8) return launch_cols<double>(g, index, rows, cols, out, s);
  return (int)cudaErrorInvalidValue;
}
