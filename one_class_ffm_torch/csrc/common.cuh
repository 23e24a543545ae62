// Helpers shared by the port's kernels (blocked_ops.cu, table_ops.cu,
// project_ops.cu and hv_variants.cu): storage-dtype conversion, the warp
// sum, the slot layouts and row runs of the blocked stream, the per-row
// math of the blocked Hv and gradient passes (the latter with the Jacobi
// diagonal's second payload), the projection of one row (B8 and the table
// passes' phi = X V), the grid of a warp-per-item loop, the dtype dispatch
// of a launch, and the rows of a width fixed at compile time (vector loads
// and stores, and the dispatch over width plans) that the X^T stage and B2
// use.  Every product and sum is rounded on its own (__fmul_rn /
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

// Where slot t of a block lives.  RowMajor: the port's stream
// (MAXC, k), owner and weight at t.  Packed4: the lane-packed stream
// (MAXC/4, 128) of pos_hv_packed_pallas, entry t = j * MAXC/4 + c at
// [c, 32j:32j+32] with k = 32; its owner and weight are read from lane 0
// of the group (the other 31 copies are a TPU layout artefact).
struct RowMajor {
  int k;
  __device__ __forceinline__ int64_t row(int t) const { return (int64_t)t * k; }
  __device__ __forceinline__ int64_t scalar(int t) const { return t; }
};
struct Packed4 {
  int m4;  // MAXC / 4
  __device__ __forceinline__ int64_t row(int t) const {
    return (int64_t)(t % m4) * 128 + 32 * (t / m4);
  }
  __device__ __forceinline__ int64_t scalar(int t) const { return row(t); }
};

// First slot in [lo, n) whose owner is >= key (own is non-decreasing in
// slot order).
template <typename Slots>
__device__ __forceinline__ int lower_bound(const int* own, int lo, int n, int key,
                                           Slots sl) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (own[sl.scalar(mid)] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The slots [s, e) of row r in its block's `own` row.
template <typename Slots>
__device__ __forceinline__ void row_run(const int* own_b, int maxc, int r, int& s,
                                        int& e, Slots sl) {
  s = lower_bound(own_b, 0, maxc, r, sl);
  e = lower_bound(own_b, s, maxc, r + 1, sl);
}
__device__ __forceinline__ void row_run(const int* own_b, int maxc, int r, int& s,
                                        int& e) {
  row_run(own_b, maxc, r, s, e, RowMajor{0});
}

// The blocked Hv of one row, lanes over k (B1; pos_hv_kt_pallas):
//   acc += sum_{t in [s, e)} (w_scale * w_t) * pq_t * rows_t + ph @ dense,
//   pq_t = storage(<ph, rows_t>)
// ph holds the row's phi (zero past k); it stays in registers and is
// broadcast by shuffles for the dense term.  Slots are walked in slot
// order whatever their layout, so every layout gives B1's bits.
template <typename T, typename Slots>
__device__ __forceinline__ void hv_row(const float (&ph)[kMaxKPerLane],
                                       const T* __restrict__ rows_b,
                                       const T* __restrict__ w_b, int s, int e,
                                       const T* __restrict__ dense, int k,
                                       float w_scale, int lane,
                                       float (&acc)[kMaxKPerLane],
                                       Slots sl) {
  for (int t = s; t < e; ++t) {
    const T* rt = rows_b + sl.row(t);
    float rv[kMaxKPerLane];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int c = j * 32 + lane;
      rv[j] = c < k ? to_f(rt[c]) : 0.f;
      dot = __fadd_rn(dot, __fmul_rn(ph[j], rv[j]));
    }
    const float pq = rnd<T>(warp_sum(dot));
    const float coef = __fmul_rn(pq, __fmul_rn(w_scale, to_f(w_b[sl.scalar(t)])));
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

// The blocked gradient scatter of one row, lanes over k (B5's row stage;
// B2's function):  acc += sum_{t in [s, e)} c_t * rows_t
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

// scatter_row plus the Jacobi diagonal's positive term from the same read
// of each slot's row (B5's with_diag output; B2 rounds q_t to storage
// before its sum, blocked_ops.cu scatter_slots):
//   accq += sum_{t in [s, e)} q_t,   wq_t = storage(w_t * storage(wq_scale)),
//   q_t = wq_t * storage(rows_t^2) at f32 (the one-hot matmul of
//   _grad_cross_tbl_kernel)
template <typename T>
__device__ __forceinline__ void scatter_diag_row(
    const T* __restrict__ c_b, const T* __restrict__ w_b, float wq_scale,
    const T* __restrict__ rows_b, int s, int e, int k, int lane,
    float (&acc)[kMaxKPerLane], float (&accq)[kMaxKPerLane]) {
  const float wq = rnd<T>(wq_scale);
  for (int t = s; t < e; ++t) {
    const T* rt = rows_b + (int64_t)t * k;
    const float ct = to_f(c_b[t]);
    const float wt = rnd<T>(__fmul_rn(to_f(w_b[t]), wq));
#pragma unroll
    for (int j = 0; j < kMaxKPerLane; ++j) {
      const int cc = j * 32 + lane;
      if (cc < k) {
        const float r = to_f(rt[cc]);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(ct, r));
        accq[j] = __fadd_rn(accq[j], __fmul_rn(rnd<T>(__fmul_rn(r, r)), wt));
      }
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

// One output row of B1 (and of its variants B9, B10, which differ only in
// the slot layout or in which CTA runs the row): row r of block blk, lanes
// over k, its run found by binary search over the block's owners, phi[row]
// held in registers, the result written once at storage dtype.
template <typename T, typename Slots>
__device__ __forceinline__ void hv_out_row(const T* __restrict__ phi,
                                           const T* __restrict__ rows_b,
                                           const int* __restrict__ own_b,
                                           const T* __restrict__ w_b,
                                           const T* __restrict__ dense,
                                           T* __restrict__ out, int64_t row,
                                           int r, int maxc, int k,
                                           float w_scale, int lane, Slots sl) {
  int s, e;
  row_run(own_b, maxc, r, s, e, sl);
  float ph[kMaxKPerLane], acc[kMaxKPerLane];
#pragma unroll
  for (int j = 0; j < kMaxKPerLane; ++j) {
    const int c = j * 32 + lane;
    ph[j] = c < k ? to_f(phi[row * k + c]) : 0.f;
    acc[j] = 0.f;
  }
  hv_row(ph, rows_b, w_b, s, e, dense, k, w_scale, lane, acc, sl);
  store_row(out, row, k, lane, acc);
}

// grid for a warp-per-item grid-stride loop over n items
inline unsigned warp_grid(long long n) {
  const long long want = (n + kWarps - 1) / kWarps;
  return (unsigned)(want < 65536 ? (want > 0 ? want : 1) : 65536);
}

// ---------------------------------------------------------------------------
// Rows of a width fixed at compile time (the X^T stage and B2).  A row of k
// values is read by a group of G lanes; lane l of a group holds NV vectors
// of VE consecutive values, vector v at columns (v * G + l) * VE ..
// + VE - 1.  On the vector path VE = 16 / sizeof(T): one 16-byte load per
// vector, which needs k * sizeof(T) % 16 == 0 and 16-byte aligned rows.
// The plain-load path (VE = 1, G = 32, NV = kMaxKPerLane) takes any k up to
// 256 with one load per value.  Either way every value is summed at f32 in
// the same order, so both paths give the same bits.
// ---------------------------------------------------------------------------

// VE values of T as loaded: one 16-byte word, or one T
template <typename T, int VE> struct RawVec { uint4 v; };
template <typename T> struct RawVec<T, 1> { T v; };

template <typename T, int VE>
__device__ __forceinline__ RawVec<T, VE> load_raw(const T* p) {
  RawVec<T, VE> r;
  if constexpr (VE == 1) {
    r.v = *p;
  } else {
    static_assert(VE * sizeof(T) == 16, "one 16-byte vector");
    r.v = *reinterpret_cast<const uint4*>(p);
  }
  return r;
}

template <typename T, int VE>
__device__ __forceinline__ void unpack(const RawVec<T, VE>& r,
                                       float (&f)[VE]) {
  if constexpr (VE == 1) {
    f[0] = to_f(r.v);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(r.v.x);
    f[1] = __uint_as_float(r.v.y);
    f[2] = __uint_as_float(r.v.z);
    f[3] = __uint_as_float(r.v.w);
  } else {  // eight bf16, value 2i in the low half of word i: exact widening
    const uint32_t w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// VE values stored at storage dtype T (rounded once each)
template <typename T, int VE>
__device__ __forceinline__ void store_vals(T* p, const float (&f)[VE]) {
  if constexpr (VE == 1) {
    *p = from_f<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// VE values stored at f32 (16-byte stores where VE > 1: k % 4 == 0 there)
template <int VE>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VE]) {
  if constexpr (VE == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < VE; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

// Entries gathered per batch: their loads are all issued before the first
// of their ordered adds (about 32 registers of loaded values per lane).
template <typename T, int NV, int VE>
__host__ __device__ constexpr int batch_depth() {
  constexpr int regs = NV * (VE * (int)sizeof(T) >= 4 ? VE * (int)sizeof(T) / 4
                                                       : 1);
  return regs >= 16 ? 2 : regs >= 8 ? 4 : 8;
}

// Calls l.template run<G, NV, VE>() with the width plan of k: the vector
// path where `vec` (the smallest power-of-two group that covers k with
// 16-byte vectors, NV = 2 only for f32 k > 128), else the plain-load path.
// Returns cudaErrorInvalidValue for a k the plan does not cover.
template <typename T, typename L>
int by_width(int k, bool vec, const L& l) {
  constexpr int VE = 16 / (int)sizeof(T);
  if (!vec) return l.template run<32, kMaxKPerLane, 1>();
  const int n = k / VE;  // vectors per row
  if (n <= 1) return l.template run<1, 1, VE>();
  if (n <= 2) return l.template run<2, 1, VE>();
  if (n <= 4) return l.template run<4, 1, VE>();
  if (n <= 8) return l.template run<8, 1, VE>();
  if (n <= 16) return l.template run<16, 1, VE>();
  if (n <= 32) return l.template run<32, 1, VE>();
  if constexpr (VE * 64 <= kMaxKPerLane * 32) {
    if (n <= 64) return l.template run<32, 2, VE>();
  }
  return (int)cudaErrorInvalidValue;
}

// the vector path applies: whole 16-byte vectors per row, aligned base
inline bool vec_ok(int k, int elem_bytes, const void* const* ptrs, int n) {
  if ((k * elem_bytes) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && ((uintptr_t)ptrs[i]) % 16) return false;
  return true;
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
