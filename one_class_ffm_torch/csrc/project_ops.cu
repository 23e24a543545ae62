// Hopper (sm_90a) kernel B8: the projection of a feature field,
//   P[i] = sum_s val[i, s] * W[idx[i, s]]        idx, val (rows, p); W (D, k)
// the gather behind every phi = X V of a wide field's CG iteration, every
// dP = X S of a step, the cache refresh and the evaluator's user
// projections.  Built with the other sources into one shared library
// (ops/kernels.py), bound with ctypes.
//
// Replaces project_pallas / _project_kernel
// (one_class_ffm_tpu/ops/sparse_ops.py).  The TPU kernel turns the gather
// into a one-hot matmul against a VMEM-resident table, which caps D at what
// VMEM holds; here a warp reads the table rows it needs straight from
// device memory, so one kernel serves every field width (the FM user field
// has D = 201,000).  It keeps project_pallas's rounding: products and sums
// at f32, one rounding each (no fused multiply-add), slots in slot order,
// one cast to storage at the end; at f32 that is project_xla's slot-order
// sum bit for bit.
//
// Design: one warp per row (grid-stride), lanes over k.  The lanes load the
// row's p (id, value) slots once, coalesced, and broadcast them by shuffles
// (common.cuh project_row); each slot then reads one table row of k values,
// 128 contiguous bytes at k = 32 f32, through L2.  No atomics: two launches
// give the same bits.
//
// Bound on the H100: bytes.  The work is 2 rows p k operations against
// reading idx and val once, the table rows the data names and writing P:
// about one operation per byte at k = 32 f32 (the FM user field), far below
// the 20 operations per byte (67 TFLOP/s over 3.35 TB/s) where f32
// arithmetic would bind.  There is no reuse
// to exploit inside a row; across rows a table row that many rows name (a
// class base) is served from L2, which holds the whole (201,000, 32) f32
// table.  The random 128-byte row reads are latency-bound per warp, and the
// many independent warps (one per row) hide that latency.

#include "common.cuh"

using namespace ocffm;

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
project_kernel(const int* __restrict__ xi, const T* __restrict__ xv,
               const T* __restrict__ W, T* __restrict__ out, int64_t n_rows,
               int p, int d, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n_rows; row += n_warps) {
    float ph[kMaxKPerLane];
    project_row(W, xi, xv, row, p, d, k, lane, ph);
    store_row(out, row, k, lane, ph);
  }
}

}  // namespace

extern "C" {

int ocffm_project(int dtype, const void* xi, const void* xv, const void* W,
                  void* out, long long n_rows, int p, int d, int k,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, project_kernel<T><<<warp_grid(n_rows), kWarps * 32,
                                            0, st>>>(
      (const int*)xi, (const T*)xv, (const T*)W, (T*)out, n_rows, p, d, k));
  return (int)cudaGetLastError();
}

}  // extern "C"
