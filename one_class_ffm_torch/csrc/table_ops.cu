// Hopper (sm_90a) kernels for the fused table-space passes of a solve on
// a small-D feature field (D <= 4096): the cross-block Hv and gradient and
// the self-block Hv and gradient, the two gradients optionally with the
// Jacobi diagonal's term, a second per-row payload from the same stage 1
// that stage 2 scatters through the field's X^2 (its feature-major list's
// squared values).  Built with the other sources into one
// shared library (ops/kernels.py), bound with ctypes.  Stage 2 below, the
// X^T stage, is also the general scatter G = X^T Z of a wide field
// (ops/sparse_ops.py scatter); stage 1's phi = X V is B8's project_row.
//
// The TPU kernels keep the (D, k) table-space output in VMEM across a
// sequential grid over row blocks (out_ref[...] += X_b^T payload_b).  Here
// blocks run in parallel and in no order, and a (4096, 32) f32 table does
// not fit in one block's shared memory, so each pass runs in two stages:
//
//   1. rows: one warp per data row, lanes over k.  It computes the row's
//      payload from the row's X entries, the table V (read through L2),
//      the blocked positive stream and the dense terms, and writes it once
//      at storage dtype: the same single rounding the TPU kernels apply to
//      their zpb / zb block.  phi = X V never leaves registers.
//   2. X^T payload: over the field's static feature-major list
//      (ops/layout.py FeatureMajor).  One warp per chunk of at most
//      XT_CHUNK entries of one feature sums val * payload[row] in list
//      order into an f32 partial; one warp per feature then adds its
//      chunks' partials in chunk order.  The chunks split the few heavy
//      features (class bases carrying ~25k rows each) over many warps.
//
// No atomics anywhere: every sum runs in a fixed order, so two launches
// give the same bits and the plain versions in ops/sparse_ops.py, which add
// in the same order with the same roundings (no fused multiply-add),
// agree with the kernels bit for bit.
//
// Bounds on the H100: stage 1 streams the blocked stream `rows` once (as
// B1/B2 do) and reads each data row's p table rows from L2 (D x k is at
// most 512 KB); it is bound by device-memory bandwidth.  Stage 2 gathers
// one payload row (k values, 128 bytes at k=32 f32) per X entry: about
// 400k random 128-byte reads per pass at the headline shapes, bound by
// memory latency, which the many independent chunk warps hide.

#include "common.cuh"

using namespace ocffm;

namespace {

// Stage 1 of pos_hv_tbl, replacing pos_hv_tbl_pallas / _hv_tbl_kernel and
// its k-major twin pos_hv_tbl_kt_pallas / _hv_tbl_kt_kernel
// (one_class_ffm_tpu/ops/sparse_ops.py).  One warp per row r of block b:
//   payload[r] = storage(B1 math on phib),   phib = storage(X_r V)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
hv_tbl_rows_kernel(const T* __restrict__ V, const int* __restrict__ xi,
                   const T* __restrict__ xv, int p, int d,
                   const T* __restrict__ rows, const int* __restrict__ own,
                   const T* __restrict__ w, const T* __restrict__ dense,
                   T* __restrict__ payload, int maxc, int k, int block_rows,
                   float w_scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;  // uniform across the warp
  const int64_t blk = blockIdx.x;
  const int64_t row = blk * block_rows + r;
  float ph[kMaxKPerLane], acc[kMaxKPerLane];
  project_row(V, xi, xv, row, p, d, k, lane, ph);
  int s, e;
  row_run(own + blk * maxc, maxc, r, s, e);
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) acc[j] = 0.f;
  hv_row(ph, rows + blk * maxc * k, w + blk * maxc, s, e, dense, k, w_scale,
         lane, acc, RowMajor{k});
  store_row(payload, row, k, lane, acc);
}

// Stage 1 of grad_cross_tbl, replacing grad_cross_tbl_pallas /
// _grad_cross_tbl_kernel and grad_cross_tbl_kt_pallas.  One warp per row:
//   payload[r] = storage(dense[r] + storage(sum_{t: own_t = r} c_t rows_t))
// kDiag (the Jacobi w_blk output, from the same read of each slot's row):
//   payload_q[r] = storage(sum_{t: own_t = r} wq_t * storage(rows_t^2)),
//   wq_t = storage(w_t * storage(wq_scale)), the product at f32
// which stage 2 scatters through the field's X^2.
template <typename T, bool kDiag>
__global__ void __launch_bounds__(kWarps * 32)
grad_cross_tbl_rows_kernel(const T* __restrict__ c,
                           const T* __restrict__ w, float wq_scale,
                           const T* __restrict__ rows,
                           const int* __restrict__ own,
                           const T* __restrict__ dense,
                           T* __restrict__ payload, T* __restrict__ payload_q,
                           int maxc, int k, int block_rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;
  const int64_t blk = blockIdx.x;
  const int64_t row = blk * block_rows + r;
  int s, e;
  row_run(own + blk * maxc, maxc, r, s, e);
  float acc[kMaxKPerLane], accq[kMaxKPerLane];
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) acc[j] = accq[j] = 0.f;
  if constexpr (kDiag) {
    scatter_diag_row<T, false>(c + blk * maxc, w + blk * maxc, wq_scale,
                               rows + blk * maxc * k, s, e, k, lane, acc,
                               accq);
    store_row(payload_q, row, k, lane, accq);
  } else {
    scatter_row(c + blk * maxc, rows + blk * maxc * k, s, e, k, lane, acc);
  }
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int cc = j * 32 + lane;
    if (cc < k) acc[j] = __fadd_rn(to_f(dense[row * k + cc]), rnd<T>(acc[j]));
  }
  store_row(payload, row, k, lane, acc);
}

// Stage 1 of hv_self_tbl, replacing hv_self_tbl_pallas / _hv_self_tbl_kernel
// and hv_self_tbl_kt_pallas.  One warp per row (grid-stride):
//   payload[i] = storage(s_i * Q1[i]),
//   s_i = storage(dd_i * storage(<Q1[i], phib_i>)),  phib = storage(X_i V)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
hv_self_tbl_rows_kernel(const T* __restrict__ V, const int* __restrict__ xi,
                        const T* __restrict__ xv, int p, int d,
                        const T* __restrict__ q1, const T* __restrict__ dd,
                        T* __restrict__ payload, int64_t n_rows, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n_rows; row += n_warps) {
    float ph[kMaxKPerLane], q[kMaxKPerLane];
    project_row(V, xi, xv, row, p, d, k, lane, ph);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int c = j * 32 + lane;
      q[j] = c < k ? to_f(q1[row * k + c]) : 0.f;
      dot = __fadd_rn(dot, __fmul_rn(q[j], ph[j]));
    }
    const float s = rnd<T>(__fmul_rn(to_f(dd[row]), rnd<T>(warp_sum(dot))));
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) q[j] = __fmul_rn(s, q[j]);
    store_row(payload, row, k, lane, q);
  }
}

// Stage 1 of grad_self_tbl, replacing grad_self_tbl_pallas /
// _grad_self_tbl_kernel and grad_self_tbl_kt_pallas.  One warp per row r of
// block b; every lane adds the row's run of slot coefficients in slot
// order:
//   payload[r] = storage(zb_r * Q1[r]),
//   zb_r = storage(zdense[r] + sum_{t: own_t = r} c_t)
// kDiag (the Jacobi dd output): payload_q[r] = storage(storage(dd_r Q1[r])
// Q1[r]), which stage 2 scatters through the field's X^2.
template <typename T, bool kDiag>
__global__ void __launch_bounds__(kWarps * 32)
grad_self_tbl_rows_kernel(const T* __restrict__ q1,
                          const T* __restrict__ zdense,
                          const T* __restrict__ dd,
                          const int* __restrict__ own,
                          const T* __restrict__ c, T* __restrict__ payload,
                          T* __restrict__ payload_q, int maxc, int k,
                          int block_rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;
  const int64_t blk = blockIdx.x;
  const int64_t row = blk * block_rows + r;
  int s, e;
  row_run(own + blk * maxc, maxc, r, s, e);
  const T* c_b = c + blk * maxc;
  float z = 0.f;
  for (int t = s; t < e; ++t) z = __fadd_rn(z, to_f(c_b[t]));
  const float zb = rnd<T>(__fadd_rn(to_f(zdense[row]), z));
  float v[kMaxKPerLane], vq[kMaxKPerLane];
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int cc = j * 32 + lane;
    const float q = cc < k ? to_f(q1[row * k + cc]) : 0.f;
    v[j] = __fmul_rn(zb, q);
    if constexpr (kDiag) vq[j] = __fmul_rn(rnd<T>(__fmul_rn(to_f(dd[row]), q)), q);
  }
  store_row(payload, row, k, lane, v);
  if constexpr (kDiag) store_row(payload_q, row, k, lane, vq);
}

// Stage 2a, shared by the four passes: one warp per chunk (grid-stride),
// lanes over k.  The lanes load 32 entries' (row, val) at a time and
// broadcast them by shuffles:
//   partial[ch] = sum_{e in chunk ch} val_e * payload[row_e]   (f32)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
xt_chunk_kernel(const T* __restrict__ payload, const int* __restrict__ xf_row,
                const T* __restrict__ xf_val,
                const int* __restrict__ chunk_ptr, int n_chunks,
                float* __restrict__ partial, int k) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int ch = blockIdx.x * kWarps + (threadIdx.x >> 5); ch < n_chunks;
       ch += n_warps) {
    const int s = chunk_ptr[ch], e = chunk_ptr[ch + 1];
    float acc[kMaxKPerLane];
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) acc[j] = 0.f;
    for (int base = s; base < e; base += 32) {
      const int mine = base + lane;
      const int my_row = mine < e ? xf_row[mine] : 0;
      const float my_val = mine < e ? to_f(xf_val[mine]) : 0.f;
      const int n = min(32, e - base);
      for (int q = 0; q < n; ++q) {
        const int64_t rq = __shfl_sync(kFull, my_row, q);
        const float vq = __shfl_sync(kFull, my_val, q);
        const T* pr = payload + rq * k;
#pragma unroll
        for (int j = 0; j < kMaxKPerLane; ++j) {
          const int c = j * 32 + lane;
          if (c < k) acc[j] = __fadd_rn(acc[j], __fmul_rn(vq, to_f(pr[c])));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int c = j * 32 + lane;
      if (c < k) partial[(int64_t)ch * k + c] = acc[j];
    }
  }
}

// Stage 2b: one warp per feature f (grid-stride), lanes over k:
//   out[f] = sum_{ch in f's chunks} partial[ch], in chunk order (f32)
__global__ void __launch_bounds__(kWarps * 32)
xt_feature_kernel(const float* __restrict__ partial,
                  const int* __restrict__ feat_ptr, int d,
                  float* __restrict__ out, int k) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  for (int f = blockIdx.x * kWarps + (threadIdx.x >> 5); f < d;
       f += n_warps) {
    const int s = feat_ptr[f], e = feat_ptr[f + 1];
    float acc[kMaxKPerLane];
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) acc[j] = 0.f;
    for (int ch = s; ch < e; ++ch) {
#pragma unroll
      for (int j = 0; j < kMaxKPerLane; ++j) {
        const int c = j * 32 + lane;
        if (c < k) acc[j] = __fadd_rn(acc[j], partial[(int64_t)ch * k + c]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int c = j * 32 + lane;
      if (c < k) out[(int64_t)f * k + c] = acc[j];
    }
  }
}

}  // namespace

extern "C" {

int ocffm_pos_hv_tbl_rows(int dtype, const void* V, const void* xi,
                          const void* xv, int p, int d, const void* rows,
                          const void* own, const void* w, const void* dense,
                          void* payload, long long n_blocks, int maxc, int k,
                          int block_rows, float w_scale, void* stream) {
  const dim3 grid((unsigned)n_blocks, (block_rows + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, hv_tbl_rows_kernel<T><<<grid, kWarps * 32, 0, st>>>(
      (const T*)V, (const int*)xi, (const T*)xv, p, d, (const T*)rows,
      (const int*)own, (const T*)w, (const T*)dense, (T*)payload, maxc, k,
      block_rows, w_scale));
  return (int)cudaGetLastError();
}

// w == nullptr: the gradient payload alone; otherwise also the Jacobi
// payload into payload_q.
int ocffm_grad_cross_tbl_rows(int dtype, const void* c, const void* w,
                              float wq_scale, const void* rows,
                              const void* own, const void* dense,
                              void* payload, void* payload_q,
                              long long n_blocks, int maxc, int k,
                              int block_rows, void* stream) {
  const dim3 grid((unsigned)n_blocks, (block_rows + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  if (w == nullptr) {
    OCFFM_BY_DTYPE(dtype, grad_cross_tbl_rows_kernel<T, false><<<grid, kWarps * 32, 0, st>>>(
        (const T*)c, nullptr, wq_scale, (const T*)rows, (const int*)own,
        (const T*)dense, (T*)payload, nullptr, maxc, k, block_rows));
  } else {
    OCFFM_BY_DTYPE(dtype, grad_cross_tbl_rows_kernel<T, true><<<grid, kWarps * 32, 0, st>>>(
        (const T*)c, (const T*)w, wq_scale, (const T*)rows, (const int*)own,
        (const T*)dense, (T*)payload, (T*)payload_q, maxc, k, block_rows));
  }
  return (int)cudaGetLastError();
}

int ocffm_hv_self_tbl_rows(int dtype, const void* V, const void* xi,
                           const void* xv, int p, int d, const void* q1,
                           const void* dd, void* payload, long long n_rows,
                           int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, hv_self_tbl_rows_kernel<T><<<warp_grid(n_rows),
                                                      kWarps * 32, 0, st>>>(
      (const T*)V, (const int*)xi, (const T*)xv, p, d, (const T*)q1,
      (const T*)dd, (T*)payload, n_rows, k));
  return (int)cudaGetLastError();
}

// dd == nullptr: the gradient payload alone; otherwise also the Jacobi
// payload into payload_q.
int ocffm_grad_self_tbl_rows(int dtype, const void* q1, const void* zdense,
                             const void* dd, const void* own, const void* c,
                             void* payload, void* payload_q,
                             long long n_blocks, int maxc, int k,
                             int block_rows, void* stream) {
  const dim3 grid((unsigned)n_blocks, (block_rows + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  if (dd == nullptr) {
    OCFFM_BY_DTYPE(dtype, grad_self_tbl_rows_kernel<T, false><<<grid, kWarps * 32, 0, st>>>(
        (const T*)q1, (const T*)zdense, nullptr, (const int*)own, (const T*)c,
        (T*)payload, nullptr, maxc, k, block_rows));
  } else {
    OCFFM_BY_DTYPE(dtype, grad_self_tbl_rows_kernel<T, true><<<grid, kWarps * 32, 0, st>>>(
        (const T*)q1, (const T*)zdense, (const T*)dd, (const int*)own,
        (const T*)c, (T*)payload, (T*)payload_q, maxc, k, block_rows));
  }
  return (int)cudaGetLastError();
}

// out (d, k) f32 = X^T payload through the feature-major list; `partial`
// holds n_chunks x k floats of scratch.
int ocffm_xt_scatter(int dtype, const void* payload, const void* xf_row,
                     const void* xf_val, const void* chunk_ptr, int n_chunks,
                     const void* feat_ptr, int d, int k, void* partial,
                     void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_chunks > 0) {
    OCFFM_BY_DTYPE(dtype, xt_chunk_kernel<T><<<warp_grid(n_chunks),
                                                kWarps * 32, 0, st>>>(
        (const T*)payload, (const int*)xf_row, (const T*)xf_val,
        (const int*)chunk_ptr, n_chunks, (float*)partial, k));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  xt_feature_kernel<<<warp_grid(d), kWarps * 32, 0, st>>>(
      (const float*)partial, (const int*)feat_ptr, d, (float*)out, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
