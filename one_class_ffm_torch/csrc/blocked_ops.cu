// Hopper (sm_90a) kernels for the blocked positive-stream passes of a
// cross-block solve on an identity field.  Built by
// one_class_ffm_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
//        -fPIC -c
// (one compiler per source, in parallel) and linked with table_ops.cu into
// one shared library with a plain C interface, loaded with ctypes.
//
// Layout (one_class_ffm_torch/ops/layout.py): the solve's pre-gathered
// stream `rows` is row-major (n_blocks, MAXC, k); `own` (n_blocks, MAXC)
// names each slot's row inside its block of `block_rows` rows, with the pad
// marker own == block_rows.  Within a block `own` is non-decreasing and pads
// come last, so the slots of one row form one contiguous run.  Each row's
// run is found by binary search over its block's `own`, so the per-row sums
// need no atomics and run in a fixed order: two launches on the same input
// give the same bits.
//
// Every kernel reads storage-dtype values (f32 or bf16), accumulates in f32
// and writes storage dtype, with the rounding points of the TPU kernels
// (pq rounded to storage before it scales the row).  Products and sums are
// rounded one at a time (__fmul_rn / __fadd_rn: no fused multiply-add), in
// a fixed order that the plain PyTorch versions in ops/sparse_ops.py
// follow, so kernel and plain version agree bit for bit.
//
// All three kernels stream `rows` once per call and do O(k) flops per
// loaded element: they are bound by device-memory bandwidth, not by the
// tensor cores.  The design keeps every load of `rows` coalesced (lanes
// over k, 128 bytes per warp-row at k=32 f32) and reads it exactly once;
// phi/dP/out rows are touched once per output row or slot.  Offsets are
// 64-bit: n_blocks * MAXC * k passes 2^31 at web-scale configurations.

#include "common.cuh"

using namespace ocffm;

namespace {

// Replaces pos_hv_kt_pallas / _hv_kt_kernel (and its row-major twin
// pos_hv_blocked_pallas / _hv_blk_kernel), one_class_ffm_tpu/ops/
// sparse_ops.py.  One warp per output row r of block b, lanes over k:
//   out[r] = sum_{t: own_t = r} (w_scale * w_t) * pq_t * rows_t
//            + phi[r] @ dense,        pq_t = storage(<phi[r], rows_t>)
// The dense (omega Q1^T Q1) term is added inside the kernel, as the TPU
// kernel does; phi[r] stays in registers and is broadcast by shuffles.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pos_hv_kernel(const T* __restrict__ phi, const T* __restrict__ rows,
              const int* __restrict__ own, const T* __restrict__ w,
              const T* __restrict__ dense, T* __restrict__ out, int maxc,
              int k, int block_rows, float w_scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;  // uniform across the warp
  const int64_t blk = blockIdx.x;
  const int64_t row = blk * block_rows + r;
  int s, e;
  row_run(own + blk * maxc, maxc, r, s, e);

  float ph[kMaxKPerLane], acc[kMaxKPerLane];
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int c = j * 32 + lane;
    ph[j] = c < k ? to_f(phi[row * k + c]) : 0.f;
    acc[j] = 0.f;
  }
  hv_row(ph, rows + blk * maxc * k, w + blk * maxc, s, e, dense, k, w_scale,
         lane, acc);
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int c = j * 32 + lane;
    if (c < k) out[row * k + c] = from_f<T>(acc[j]);
  }
}

// Replaces pos_scatter_kt_pallas / _scatter_kt_kernel (without the Jacobi
// w_blk payload).  One warp per output row, lanes over k:
//   out[r] = sum_{t: own_t = r} c_t * rows_t
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pos_scatter_kernel(const T* __restrict__ c, const T* __restrict__ rows,
                   const int* __restrict__ own, T* __restrict__ out, int maxc,
                   int k, int block_rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;
  const int64_t blk = blockIdx.x;
  const int64_t row = blk * block_rows + r;
  int s, e;
  row_run(own + blk * maxc, maxc, r, s, e);

  float acc[kMaxKPerLane];
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) acc[j] = 0.f;
  scatter_row(c + blk * maxc, rows + blk * maxc * k, s, e, k, lane, acc);
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int cc = j * 32 + lane;
    if (cc < k) out[row * k + cc] = from_f<T>(acc[j]);
  }
}

// Replaces pos_gap_kt_pallas / _gap_kt_kernel.  One warp per slot t (grid-
// stride), lanes over k:  gap_t = <dP[own_t], rows_t>, written flat in slot
// order; pad slots get exactly 0.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pos_gap_kernel(const T* __restrict__ dP, const T* __restrict__ rows,
               const int* __restrict__ own, T* __restrict__ out,
               int64_t n_slots, int maxc, int k, int block_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < n_slots; t += n_warps) {
    const int o = own[t];
    float dot = 0.f;
    if (o < block_rows) {  // uniform across the warp
      const int64_t row = (t / maxc) * block_rows + o;
      const T* rt = rows + t * k;
      const T* dr = dP + row * k;
#pragma unroll
      for (int j = 0; j < kMaxKPerLane; ++j) {
        const int c = j * 32 + lane;
        if (c < k) dot = __fadd_rn(dot, __fmul_rn(to_f(dr[c]), to_f(rt[c])));
      }
      dot = warp_sum(dot);
    }
    if (lane == 0) out[t] = from_f<T>(dot);
  }
}

}  // namespace

extern "C" {

int ocffm_max_k() { return kMaxKPerLane * 32; }

int ocffm_pos_hv_blocked(int dtype, const void* phi, const void* rows,
                         const void* own, const void* w, const void* dense,
                         void* out, long long n_blocks, int maxc, int k,
                         int block_rows, float w_scale, void* stream) {
  const dim3 grid((unsigned)n_blocks, (block_rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    pos_hv_kernel<float><<<grid, block, 0, st>>>(
        (const float*)phi, (const float*)rows, (const int*)own,
        (const float*)w, (const float*)dense, (float*)out, maxc, k,
        block_rows, w_scale);
  } else if (dtype == kBF16) {
    pos_hv_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)phi, (const __nv_bfloat16*)rows,
        (const int*)own, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)dense, (__nv_bfloat16*)out, maxc, k,
        block_rows, w_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int ocffm_pos_scatter_blocked(int dtype, const void* c, const void* rows,
                              const void* own, void* out, long long n_blocks,
                              int maxc, int k, int block_rows, void* stream) {
  const dim3 grid((unsigned)n_blocks, (block_rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    pos_scatter_kernel<float><<<grid, block, 0, st>>>(
        (const float*)c, (const float*)rows, (const int*)own, (float*)out,
        maxc, k, block_rows);
  } else if (dtype == kBF16) {
    pos_scatter_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)c, (const __nv_bfloat16*)rows,
        (const int*)own, (__nv_bfloat16*)out, maxc, k, block_rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int ocffm_pos_gap_blocked(int dtype, const void* dP, const void* rows,
                          const void* own, void* out, long long n_blocks,
                          int maxc, int k, int block_rows, void* stream) {
  const long long n_slots = n_blocks * (long long)maxc;
  const long long want = (n_slots + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(want < 65536 ? want : 65536);
  const dim3 block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) {
    pos_gap_kernel<float><<<grid, block, 0, st>>>(
        (const float*)dP, (const float*)rows, (const int*)own, (float*)out,
        n_slots, maxc, k, block_rows);
  } else if (dtype == kBF16) {
    pos_gap_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)dP, (const __nv_bfloat16*)rows,
        (const int*)own, (__nv_bfloat16*)out, n_slots, maxc, k, block_rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
