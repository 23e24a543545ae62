// Hopper (sm_90a) kernels for two variants of the blocked cross Hv (B1)
// that the TPU package tried as experiments and never wired into its
// solver: B9, B1's function read from a lane-packed stream, and B10, B1 with
// G row blocks per CTA.  Their one caller is the comparison in
// one_class_ffm_torch/hv_pack_bench.py (each variant against B1 on the same
// stream).  Built with the other sources into one shared library
// (ops/kernels.py), bound with ctypes.
//
// Both compute, for row r of block b,
//   out[r] = sum_{t: own_t = r} (w_scale * w_t) * pq_t * rows_t
//            + phi[r] @ dense,        pq_t = storage(<phi[r], rows_t>)
// through B1's own row routine (common.cuh hv_out_row): the slots of a row
// are walked in slot order with the same roundings, so both give B1's
// bits.  Like B1 they read the stream once and do O(k) flops per element
// read: they are bound by device-memory bandwidth.
//
// What the TPU layouts were for, and what is left of them here:
// - The packed layout (n_blocks, MAXC/4, 128) put four k = 32 entries in one
//   128-lane row so that the MXU's M dimension grew from k to MAXC/4; entry
//   e = j * MAXC/4 + c sits at [c, 32j:32j+32], and its owner and weight are
//   copied to all 32 lanes of the group.  A warp reads an entry's 32 values
//   as one coalesced 128-byte row (f32) wherever it sits, so B9 costs the
//   index arithmetic of Packed4 and nothing else; it reads one lane of each
//   owner/weight group (1/32 of those arrays).
// - G blocks per grid step amortised the TPU's per-step overhead.  Here a
//   CTA runs 8 rows (one per warp) of each of its G blocks in turn; the CTA
//   count drops by G and each warp does G rows.

#include "common.cuh"

using namespace ocffm;

namespace {

// B9, replacing pos_hv_packed_pallas (scripts/hv_pack_bench.py).  One warp
// per output row r of block b, lanes over k = 32.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pos_hv_packed_kernel(const T* __restrict__ phi, const T* __restrict__ rows_p,
                     const int* __restrict__ own_p, const T* __restrict__ w_p,
                     const T* __restrict__ dense, T* __restrict__ out,
                     int maxc, int block_rows, float w_scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;  // uniform across the warp
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * (int64_t)maxc * 32;  // (MAXC/4) x 128 per block
  hv_out_row(phi, rows_p + base, own_p + base, w_p + base, dense, out,
             blk * block_rows + r, r, maxc, 32, w_scale, lane,
             Packed4{maxc / 4});
}

// B10, replacing pos_hv_kt_g_pallas (scripts/hv_pack_bench.py), on the
// port's row-major stream (the k-major layout was a TPU lane workaround).
// CTA x runs blocks [x * G, (x + 1) * G); warp w of CTA (x, y) runs row
// y * 8 + w of each.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pos_hv_g_kernel(const T* __restrict__ phi, const T* __restrict__ rows,
                const int* __restrict__ own, const T* __restrict__ w,
                const T* __restrict__ dense, T* __restrict__ out, int maxc,
                int k, int block_rows, int groups, float w_scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (r >= block_rows) return;
  for (int g = 0; g < groups; ++g) {
    const int64_t blk = (int64_t)blockIdx.x * groups + g;
    hv_out_row(phi, rows + blk * maxc * k, own + blk * maxc, w + blk * maxc,
               dense, out, blk * block_rows + r, r, maxc, k, w_scale, lane,
               RowMajor{k});
  }
}

}  // namespace

extern "C" {

int ocffm_pos_hv_packed(int dtype, const void* phi, const void* rows_p,
                        const void* own_p, const void* w_p, const void* dense,
                        void* out, long long n_blocks, int maxc,
                        int block_rows, float w_scale, void* stream) {
  if (maxc % 4 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_blocks, (block_rows + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, pos_hv_packed_kernel<T><<<grid, kWarps * 32, 0, st>>>(
      (const T*)phi, (const T*)rows_p, (const int*)own_p, (const T*)w_p,
      (const T*)dense, (T*)out, maxc, block_rows, w_scale));
  return (int)cudaGetLastError();
}

int ocffm_pos_hv_blocked_g(int dtype, const void* phi, const void* rows,
                           const void* own, const void* w, const void* dense,
                           void* out, long long n_blocks, int maxc, int k,
                           int block_rows, int groups, float w_scale,
                           void* stream) {
  if (groups < 1 || n_blocks % groups != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n_blocks / groups),
                  (block_rows + kWarps - 1) / kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, pos_hv_g_kernel<T><<<grid, kWarps * 32, 0, st>>>(
      (const T*)phi, (const T*)rows, (const int*)own, (const T*)w,
      (const T*)dense, (T*)out, maxc, k, block_rows, groups, w_scale));
  return (int)cudaGetLastError();
}

}  // extern "C"
