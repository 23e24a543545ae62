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
// VMEM holds; here a group of lanes reads the table rows it needs straight
// from device memory, so one kernel serves every field width (the FM user
// field has D = 201,000).  It keeps project_pallas's rounding: products and
// sums at f32, one rounding each (no fused multiply-add), slots in slot
// order, one cast to storage at the end; at f32 that is project_xla's
// slot-order sum bit for bit.  No atomics: two launches give the same bits.
//
// Bound on the H100: bytes.  The work is 2 rows p k operations against
// reading idx and val once, the table rows the data names and writing P:
// about one operation per byte at k = 32 f32, far below the 20 operations
// per byte (67 TFLOP/s over 3.35 TB/s) where f32 arithmetic would bind.
// There is no reuse inside a row; across rows a table row that many rows
// name is served from L2, which holds even FM's (201,000, 32) f32 table.
// What the card makes slow is the latency of each row's chain of loads.
//
// Design: common.cuh project_rows, the group-per-row body B6's row stage
// shares: a group of G lanes per row on a width plan fixed at compile time
// (any by_width plan: B8 has no cross-lane sum, so every plan adds each
// column's products in slot order and keeps the bits), a grid of resident
// CTAs whose groups walk rows in turn with the next slots loading under the
// current table rows, and one 16-byte store per lane of the output row.

#include "common.cuh"

using namespace ocffm;

namespace {

// B8's part of a row: the store of phi
template <typename T>
struct StoreRow {
  T* out;
  int k;
  template <int NV, int VE>
  struct Held {};
  template <int G, int NV, int VE>
  __device__ __forceinline__ void begin(int64_t, int, Held<NV, VE>&) const {}
  template <int G, int NV, int VE>
  __device__ __forceinline__ void end(int64_t row, int lane,
                                      const float (&ph)[NV][VE],
                                      const Held<NV, VE>&) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (c0 < k) store_vals<T, VE>(out + row * k + c0, ph[v]);
    }
  }
};

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kProjThreads, kProjCtas)
project_rows_kernel(ProjectedPhi<T> pj, StoreRow<T> rw, int64_t n_rows) {
  project_rows<T, G, NV, VE>(pj, rw, n_rows);
}

template <typename T>
struct ProjectLaunch {
  ProjectedPhi<T> pj;
  StoreRow<T> rw;
  long long n_rows;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    static const long long resident =
        resident_ctas(project_rows_kernel<T, G, NV, VE>);
    const unsigned grid = proj_grid(n_rows, G, resident);
    project_rows_kernel<T, G, NV, VE><<<grid, kProjThreads, 0, st>>>(
        pj, rw, n_rows);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int ocffm_project(int dtype, const void* xi, const void* xv, const void* W,
                  void* out, long long n_rows, int p, int d, int k,
                  void* stream) {
  const void* ptrs[] = {W, out};
  const bool vec = vec_ok(k, dtype == kF32 ? 4 : 2, ptrs, 2);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec, ProjectLaunch<T>{
      {(const T*)W, (const int*)xi, (const T*)xv, p, d, k}, {(T*)out, k},
      n_rows, (cudaStream_t)stream}));
}

}  // extern "C"
