// Helpers shared by the port's kernels (blocked_ops.cu, table_ops.cu and
// project_ops.cu): storage-dtype conversion, the warp sum, the row runs of
// the blocked layout, the per-row math of the blocked Hv and gradient
// passes, the projection of one row (B8 and the table passes' phi = X V),
// the grid of a warp-per-item loop and the dtype dispatch of a launch.  Every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn: no fused multiply-add) in a fixed order, which the plain
// PyTorch versions in ops/sparse_ops.py follow bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ocffm {

constexpr int kMaxKPerLane = 8;  // k <= 256
constexpr int kWarps = 8;        // warps per CTA
constexpr unsigned kFull = 0xffffffffu;

// dtype codes shared with ops/kernels.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// x rounded to storage and back: the kernels' rounding points
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// First slot in [lo, n) whose owner is >= key (own is non-decreasing).
__device__ __forceinline__ int lower_bound(const int* own, int lo, int n, int key) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (own[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The slots [s, e) of row r in its block's `own` row.
__device__ __forceinline__ void row_run(const int* own_b, int maxc, int r, int& s,
                                        int& e) {
  s = lower_bound(own_b, 0, maxc, r);
  e = lower_bound(own_b, s, maxc, r + 1);
}

// The blocked Hv of one row, lanes over k (B1; pos_hv_kt_pallas):
//   acc += sum_{t in [s, e)} (w_scale * w_t) * pq_t * rows_t + ph @ dense,
//   pq_t = storage(<ph, rows_t>)
// ph holds the row's phi (zero past k); it stays in registers and is
// broadcast by shuffles for the dense term.
template <typename T>
__device__ __forceinline__ void hv_row(const float (&ph)[kMaxKPerLane],
                                       const T* __restrict__ rows_b,
                                       const T* __restrict__ w_b, int s, int e,
                                       const T* __restrict__ dense, int k,
                                       float w_scale, int lane,
                                       float (&acc)[kMaxKPerLane]) {
  for (int t = s; t < e; ++t) {
    const T* rt = rows_b + (int64_t)t * k;
    float rv[kMaxKPerLane];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int c = j * 32 + lane;
      rv[j] = c < k ? to_f(rt[c]) : 0.f;
      dot = __fadd_rn(dot, __fmul_rn(ph[j], rv[j]));
    }
    const float pq = rnd<T>(warp_sum(dot));
    const float coef = __fmul_rn(pq, __fmul_rn(w_scale, to_f(w_b[t])));
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(coef, rv[j]));
  }
  // dense term: acc[l] += sum_i ph[i] * dense[i, l]
#pragma unroll
  for (int jb = 0; jb < kMaxKPerLane; ++jb) {
    if (jb * 32 >= k) break;
    for (int q = 0; q < 32; ++q) {
      const int i = jb * 32 + q;
      if (i >= k) break;
      const float pi = __shfl_sync(kFull, ph[jb], q);
      const T* drow = dense + (int64_t)i * k;
#pragma unroll
      for (int j = 0; j < kMaxKPerLane; ++j) {
        const int c = j * 32 + lane;
        if (c < k) acc[j] = __fadd_rn(acc[j], __fmul_rn(pi, to_f(drow[c])));
      }
    }
  }
}

// The blocked gradient scatter of one row, lanes over k (B2;
// pos_scatter_kt_pallas):  acc += sum_{t in [s, e)} c_t * rows_t
template <typename T>
__device__ __forceinline__ void scatter_row(const T* __restrict__ c_b,
                                            const T* __restrict__ rows_b, int s,
                                            int e, int k, int lane,
                                            float (&acc)[kMaxKPerLane]) {
  for (int t = s; t < e; ++t) {
    const T* rt = rows_b + (int64_t)t * k;
    const float ct = to_f(c_b[t]);
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int cc = j * 32 + lane;
      if (cc < k) acc[j] = __fadd_rn(acc[j], __fmul_rn(ct, to_f(rt[cc])));
    }
  }
}

// The projection of one row, lanes over k (B8; project_pallas):
//   ph = storage(sum_s val[row, s] * V[idx[row, s]])
// Lanes load the row's p (id, value) slots once, 32 at a time, and
// broadcast them by shuffles; the slots are added in slot order at f32, one
// rounding per product and per sum, and rounded to storage once at the end
// (zero past k).  Ids outside [0, d) add nothing, as the one-hot X of the
// TPU kernels drops them.  Offsets into the table are 64-bit.
template <typename T>
__device__ __forceinline__ void project_row(const T* __restrict__ V,
                                            const int* __restrict__ xi,
                                            const T* __restrict__ xv,
                                            int64_t row, int p, int d, int k,
                                            int lane,
                                            float (&ph)[kMaxKPerLane]) {
  float acc[kMaxKPerLane];
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) acc[j] = 0.f;
  const int* xi_r = xi + row * p;
  const T* xv_r = xv + row * p;
  for (int base = 0; base < p; base += 32) {
    const int mine = base + lane;
    const int my_f = mine < p ? xi_r[mine] : -1;
    const float my_v = mine < p ? to_f(xv_r[mine]) : 0.f;
    const int n = min(32, p - base);
    for (int q = 0; q < n; ++q) {
      const int f = __shfl_sync(kFull, my_f, q);
      const float v = __shfl_sync(kFull, my_v, q);
      if ((unsigned)f >= (unsigned)d) continue;  // uniform across the warp
      const T* vr = V + (int64_t)f * k;
#pragma unroll
      for (int j = 0; j < kMaxKPerLane; ++j) {
        const int c = j * 32 + lane;
        if (c < k) acc[j] = __fadd_rn(acc[j], __fmul_rn(v, to_f(vr[c])));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) ph[j] = rnd<T>(acc[j]);
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ out, int64_t row,
                                          int k, int lane,
                                          const float (&v)[kMaxKPerLane]) {
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int c = j * 32 + lane;
    if (c < k) out[row * k + c] = from_f<T>(v[j]);
  }
}

// grid for a warp-per-item grid-stride loop over n items
inline unsigned warp_grid(long long n) {
  const long long want = (n + kWarps - 1) / kWarps;
  return (unsigned)(want < 65536 ? (want > 0 ? want : 1) : 65536);
}

}  // namespace ocffm

// Run the launch statement in the remaining arguments with T = float or
// __nv_bfloat16 by dtype code (variadic: the launch holds commas).
#define OCFFM_BY_DTYPE(dtype, ...)                  \
  if ((dtype) == ocffm::kF32) {                     \
    using T = float;                                \
    __VA_ARGS__;                                    \
  } else if ((dtype) == ocffm::kBF16) {             \
    using T = __nv_bfloat16;                        \
    __VA_ARGS__;                                    \
  } else {                                          \
    return (int)cudaErrorInvalidValue;              \
  }
