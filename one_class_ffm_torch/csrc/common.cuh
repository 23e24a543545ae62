// Helpers shared by the port's kernels (blocked_ops.cu, table_ops.cu,
// project_ops.cu, hv_variants.cu and coo_ops.cu): storage-dtype
// conversion, the warp sum, the grids of warp- and group-per-item loops,
// the dtype dispatch of a launch, the rows of a width fixed at compile time
// (vector loads and stores, f32 rows read through L2, and the dispatch over
// width plans) that the X^T stage, B2, B5's row stage, the blocked Hv and
// the COO passes use, the shared-memory stages that bulk asynchronous copies
// fill (B2 and B5's row stage, and the stage loop over a CTA's span of the
// stream, HvSpan, that B1, B3, B4's row stage, B9 and B10 run: B10 one ring
// across its G blocks, B9 from the lane-packed stream through its own
// stream layout, hv_variants.cu PackedStream), the blocked Hv of a CTA's
// rows on a width plan (B1, B4's row stage and B9, and its end, hv_finish,
// that B10 shares), and the projection phi = X V of a row by a group of
// lanes with the loop that walks a group's rows (B8, B6's row stage; B4's
// stage 1), and the end of a chunk of a chunked list (chunk_finish: the X^T
// stage's and the COO passes').
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// fused multiply-add) in a fixed order, which the plain PyTorch versions in
// ops/sparse_ops.py follow bit for bit.
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

// VE f32 values from device memory through L2 (cache-global: rows another
// SM wrote during this launch are never read from a stale L1 line)
template <int VE>
__device__ __forceinline__ void load_f32_cg(const float* p, float (&f)[VE]) {
  if constexpr (VE == 1) {
    f[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VE; i += 4) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p + i));
      f[i] = x.x;
      f[i + 1] = x.y;
      f[i + 2] = x.z;
      f[i + 3] = x.w;
    }
  }
}

// grid of a group-per-item grid-stride loop over n items
inline unsigned group_grid(long long n, int G) {
  const long long per_cta = kWarps * 32 / G;
  const long long want = (n + per_cta - 1) / per_cta;
  return (unsigned)(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20));
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

// ---------------------------------------------------------------------------
// Shared-memory stages filled by bulk asynchronous copies (cp.async.bulk,
// completed on an mbarrier per stage: the copy engine moves the bytes, no
// thread waits on a load).  B2 and the blocked Hv stream a CTA's span of
// the blocked stream through a ring of kStages stages.  A bulk copy needs
// 16-byte-aligned addresses and sizes.
// ---------------------------------------------------------------------------

constexpr int kStages = 2;         // shared-memory stages in the ring
constexpr int kStageBytes = 8192;  // stream bytes per stage (about)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// makes the initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from device memory into shared memory, both
// 16-byte aligned; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// slots per shared-memory stage for rows of `row_bytes`: about
// `stage_bytes` of the stream, a multiple of 8 slots
inline int stage_slots_for(int row_bytes, int stage_bytes = kStageBytes) {
  const int n = (stage_bytes / row_bytes) & ~7;
  return n > 8 ? n : 8;
}

// ---------------------------------------------------------------------------
// The blocked Hv of a CTA's rows on a width plan (B1, B4's row stage and
// B9, which reads the lane-packed stream; B3 runs its stage loop, HvSpan,
// for the slot dots alone):
// for row r of block b,
//   out[r] = sum_{t: own_t = r} (w_scale * w_t) * pq_t * rows_t
//            + phi[r] @ dense,        pq_t = storage(<phi[r], rows_t>)
// in the order and with the roundings of pos_hv_blocked_plain: each dot is
// _lane_dot's tree (lane l of 32 sums columns l, l + 32, ... in turn, then
// an xor butterfly at 16, 8, 4, 2, 1), the slots are added in slot order,
// then the dense term, i ascending.
//
// What held a warp per row (the first port of B1, B4 and B9) back on the
// H100, and what this does about it:
// - a binary search per row over the block's owners: each row's run is read
//   from the static run pointer `runs` (layout.row_runs);
// - the stream by the warp's own loads, one slot per dependent chain (load,
//   dot, five shuffles, scale, add): a CTA owns kRows consecutive rows of
//   one block, whose runs are one contiguous span of slots, and one thread
//   streams that span's rows and weights into a ring of shared-memory
//   stages (as B2 does);
// - one row's slots at a time per warp, so a stage that holds one or two
//   rows' long runs (the v side: 44 slots per row) left most warps idle:
//   each stage runs in two phases, (1) every group computes the dots of
//   batches of D slots, whichever rows own them, into per-slot
//   coefficients, and (2) each row's group adds its slots' scaled rows in
//   slot order;
// - eight generic values per lane for any k <= 256 (47 registers, 5 CTAs
//   per SM): the width is a template argument (by_width) and a group of G
//   lanes serves a row, so at k = 32 a warp serves 4 rows (f32: 8 lanes x
//   one float4) or 8 (bf16: 4 lanes x 8 values);
// - the dense term by 32 shuffles per output row: phi sits in shared
//   memory, dense is read as vectors through L1, which the SM's CTAs share.
// The butterfly keeps _lane_dot's bits with fewer shuffles: lane g of a
// group holds columns g * VE + i (i < VE), so the partner of column c at
// offset o >= VE is the same i in lane g ^ (o / VE) (a shuffle inside the
// group), at o < VE column c ^ o of the same lane (an add in registers).
// A partner at or past k holds +0, and a partner lane past the group (G *
// VE < 32) is +0 too: the level adds that +0 rather than skipping it (-0 +
// +0 is +0, as in _lane_dot's zero padding).  Every lane ends with the same
// bits.
//
// Two paths, one kernel per plan: the staged path (VE > 1, k <= 32, MAXC %
// 8 == 0, 16-byte-aligned rows: bulk copies need it; B9 takes it alone,
// k = 32 and any MAXC % 4 == 0) and the plain-load
// path (G = 32, VE = 1, NV = kMaxKPerLane: one lane per column of 32, any k
// up to 256), which reads the stream and dense from device memory.  Both
// give the same bits.
// ---------------------------------------------------------------------------

constexpr int kHvThreads = 64;  // threads per CTA of hv_rows

// slots per batch of the Hv's dots and adds.  On the H100 at k = 32, two
// ran B1 and B4 faster than three, four or eight (more registers per
// thread, fewer CTAs per SM) and no slower than one; 64-thread CTAs with
// B2's ~8 KB stages ran within a few percent of the best of 32- to
// 256-thread CTAs and 2 to 16 KB stages on both sides.
constexpr int kHvBatch = 2;

// the lanes of this thread's group of G (groups are aligned in the warp)
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return kFull;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// _lane_dot's butterfly over the 32 lane sums of D dots at once, lane g
// holding the sums of columns g * VE + i in x[j][i]; on return every value
// of x[j] holds dot j.
template <int G, int VE, int D>
__device__ __forceinline__ void lane_tree(float (&x)[D][VE], unsigned gmask) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off >= VE) {
      const int lo = off / VE;
      if (lo >= G) {  // the partner column lies past the group: +0
#pragma unroll
        for (int j = 0; j < D; ++j)
#pragma unroll
          for (int i = 0; i < VE; ++i) x[j][i] = __fadd_rn(x[j][i], 0.f);
      } else {
        float y[D][VE];
#pragma unroll
        for (int j = 0; j < D; ++j)
#pragma unroll
          for (int i = 0; i < VE; ++i)
            y[j][i] = __shfl_xor_sync(gmask, x[j][i], lo, G);
#pragma unroll
        for (int j = 0; j < D; ++j)
#pragma unroll
          for (int i = 0; i < VE; ++i) x[j][i] = __fadd_rn(x[j][i], y[j][i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j)
#pragma unroll
        for (int i = 0; i < VE; ++i)
          if (!(i & off)) {
            const float s = __fadd_rn(x[j][i], x[j][i ^ off]);
            x[j][i] = s;
            x[j][i ^ off] = s;
          }
    }
  }
}

// The plain-load path: adds the slots [lo, hi) of one row to acc, slot t's
// row at rows_p + t * k and its weight at w_p[t] in device memory.  Batches
// of D slots: their loads first, then their dots and trees interleaved,
// then their scaled rows in slot order.
template <typename T, int G, int NV, int VE>
__device__ __forceinline__ void hv_slots(const T* rows_p, const T* w_p,
                                         int lo, int hi, int k,
                                         int lane, unsigned gmask,
                                         float w_scale,
                                         const float (&ph)[NV][VE],
                                         float (&acc)[NV][VE]) {
  static_assert(NV == 1 || G * VE == 32, "lane l sums columns l + 32 j");
  constexpr int D = kHvBatch;
  for (int t0 = lo; t0 < hi; t0 += D) {
    RawVec<T, VE> raw[D][NV];
    float ws[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      ws[j] = 0.f;
      if (t0 + j < hi) {
        const int64_t o = t0 + j;
        ws[j] = __fmul_rn(w_scale, to_f(w_p[o]));
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * G + lane) * VE;
          if (c0 < k) raw[j][v] = load_raw<T, VE>(rows_p + o * k + c0);
        }
      }
    }
    float r[D][NV][VE], x[D][VE];
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (t0 + j < hi && (v * G + lane) * VE < k) {
          unpack(raw[j][v], r[j][v]);
        } else {
#pragma unroll
          for (int i = 0; i < VE; ++i) r[j][v][i] = 0.f;
        }
      }
      // lane sums: columns l, l + 32, ... in turn (products past k are +0)
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        x[j][i] = __fmul_rn(ph[0][i], r[j][0][i]);
#pragma unroll
        for (int v = 1; v < NV; ++v)
          if (v * G * VE < k)
            x[j][i] = __fadd_rn(x[j][i], __fmul_rn(ph[v][i], r[j][v][i]));
      }
    }
    lane_tree<G, VE, D>(x, gmask);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (t0 + j < hi) {
        const float coef = __fmul_rn(rnd<T>(x[j][0]), ws[j]);
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int i = 0; i < VE; ++i)
            acc[v][i] = __fadd_rn(acc[v][i], __fmul_rn(coef, r[j][v][i]));
      }
  }
}

// phi[row] from device memory (B1); zero past k and for a row past the
// block
template <typename T>
struct RowPhi {
  const T* phi;
  int k;
  template <int G, int NV, int VE>
  __device__ __forceinline__ void load(bool live, int64_t row, int lane,
                                       float (&ph)[NV][VE]) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (live && c0 < k) {
        unpack(load_raw<T, VE>(phi + row * k + c0), ph[v]);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) ph[v][i] = 0.f;
      }
    }
  }
};

// A batch of P (id, value) slots of one row; id -1 past the row's p slots
// or for a row that is not live.
template <int P>
struct SlotBatch {
  int f[P];
  float val[P];
};

// phi[row] = storage(X_row V) by the row's group of G lanes (B8, B6's row
// stage, B4's stage 1; project_pallas's rounding): the row's p (id, value)
// slots added in slot order at f32, one rounding per product and per sum,
// one rounding to storage at the end; ids outside [0, d) add nothing, as
// the one-hot X of the TPU kernels drops them; offsets are 64-bit.  A
// batch of P table rows is in flight before their ordered adds.  V is read
// through L1 and L2: a feature field's table of D <= 4096 rows (B4, B6; 512
// KB at k = 32 f32) stays in L2, and so does the widest table B8 reads, FM's
// user field (D = 201,000: 25.7 MB at k = 32 f32, in the 50 MB L2).
template <typename T>
struct ProjectedPhi {
  const T* V;
  const int* xi;
  const T* xv;
  int p, d, k;

  // table rows per batch
  template <int NV>
  __host__ __device__ static constexpr int batch() {
    return NV > 1 ? 2 : 4;
  }

  // slots [s0, s0 + P) of the row
  template <int P>
  __device__ __forceinline__ void slots(bool live, int64_t row, int s0,
                                        SlotBatch<P>& s) const {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const bool in = live && s0 + q < p;
      s.f[q] = in ? xi[row * p + s0 + q] : -1;
      s.val[q] = in ? to_f(xv[row * p + s0 + q]) : 0.f;
    }
  }

  // the batch's table rows, every load issued before any is used
  template <int G, int NV, int VE, int P>
  __device__ __forceinline__ void gather(const SlotBatch<P>& s, int lane,
                                         RawVec<T, VE> (&raw)[P][NV]) const {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if ((unsigned)s.f[q] < (unsigned)d) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * G + lane) * VE;
          if (c0 < k) raw[q][v] = load_raw<T, VE>(V + (int64_t)s.f[q] * k + c0);
        }
      }
  }

  // the batch's products added in slot order
  template <int G, int NV, int VE, int P>
  __device__ __forceinline__ void add(const SlotBatch<P>& s,
                                      const RawVec<T, VE> (&raw)[P][NV],
                                      int lane, float (&acc)[NV][VE]) const {
#pragma unroll
    for (int q = 0; q < P; ++q)
      if ((unsigned)s.f[q] < (unsigned)d) {  // uniform across the group
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if ((v * G + lane) * VE >= k) continue;
          float x[VE];
          unpack(raw[q][v], x);
#pragma unroll
          for (int i = 0; i < VE; ++i)
            acc[v][i] = __fadd_rn(acc[v][i], __fmul_rn(s.val[q], x[i]));
        }
      }
  }

  // the sums rounded to storage, zero past k
  template <int G, int NV, int VE>
  __device__ __forceinline__ void rounded(const float (&acc)[NV][VE],
                                          int lane, float (&ph)[NV][VE]) const {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VE; ++i)
        ph[v][i] = (v * G + lane) * VE < k ? rnd<T>(acc[v][i]) : 0.f;
  }

  // one row, batch after batch (B4's stage 1, in hv_rows)
  template <int G, int NV, int VE>
  __device__ __forceinline__ void load(bool live, int64_t row, int lane,
                                       float (&ph)[NV][VE]) const {
    constexpr int P = batch<NV>();
    float acc[NV][VE];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[v][i] = 0.f;
    for (int s0 = 0; live && s0 < p; s0 += P) {
      SlotBatch<P> s;
      slots(true, row, s0, s);
      RawVec<T, VE> raw[P][NV];
      gather<G, NV, VE>(s, lane, raw);
      add<G, NV, VE>(s, raw, lane, acc);
    }
    rounded<G, NV, VE>(acc, lane, ph);
  }
};

// Phase 1 of a stage on the staged path: the slot values of the CTA's slots
// [lo, hi) in the stage (slot t at offset t - ws), written to coef_s:
// storage(<phi[own_t], rows_t>), times (w_scale * w_t) where kWeighted (B1,
// B4: the coefficient of the slot's row), as it is otherwise (B3: the gap).
// Every group takes batches of D consecutive slots in turn, whichever rows
// own them, so a stage that holds one or two rows' long runs keeps all
// groups busy.  Slot t's row within the CTA is the last g with runs_s[g] <=
// t.  Slot t's weight is buf_w[(t - ws) * WS] (the stream layout's
// kWStride).
template <typename T, int G, int VE, int kRows, bool kWeighted, int WS>
__device__ __forceinline__ void hv_stage_dots(
    const T* buf, const T* buf_w, int ws, int lo, int hi, int k, int lane,
    int grp, unsigned gmask, float w_scale, const int* runs_s,
    const float* phi_s, int kp, float* coef_s) {
  constexpr int D = kHvBatch;
  const int c0 = lane * VE;
  for (int t0 = lo + grp * D; t0 < hi; t0 += kRows * D) {
    RawVec<T, VE> raw[D];
    float wt[D];
    int og[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int t = t0 + j;
      wt[j] = 0.f;
      og[j] = 0;
      if (t < hi) {
        const int o = t - ws;
        if (c0 < k) raw[j] = load_raw<T, VE>(buf + (int64_t)o * k + c0);
        if constexpr (kWeighted)
          wt[j] = __fmul_rn(w_scale, to_f(buf_w[o * WS]));
        int g = 0;
#pragma unroll
        for (int step = kRows / 2; step > 0; step >>= 1)
          if (runs_s[g + step] <= t) g += step;
        og[j] = g;
      }
    }
    float x[D][VE];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float r[VE], p[VE];
      if (t0 + j < hi && c0 < k) {
        unpack(raw[j], r);
        const float* pr = phi_s + og[j] * kp + c0;
#pragma unroll
        for (int i = 0; i < VE; i += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + i);
          p[i] = p4.x;
          p[i + 1] = p4.y;
          p[i + 2] = p4.z;
          p[i + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) r[i] = p[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VE; ++i) x[j][i] = __fmul_rn(p[i], r[i]);
    }
    lane_tree<G, VE, D>(x, gmask);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (t0 + j < hi) {
          const float dot = rnd<T>(x[j][0]);
          coef_s[t0 + j - ws] = kWeighted ? __fmul_rn(dot, wt[j]) : dot;
        }
    }
  }
}

// Phase 2 of a stage: one row's slots [lo, hi) of the stage added to acc in
// slot order, acc += coef_t * rows_t, batches of D loads ahead of the adds.
template <typename T, int VE>
__device__ __forceinline__ void hv_stage_adds(const T* buf,
                                              const float* coef_s, int ws,
                                              int lo, int hi, int k, int c0,
                                              float (&acc)[VE]) {
  constexpr int D = kHvBatch;
  for (int t0 = lo; t0 < hi; t0 += D) {
    RawVec<T, VE> raw[D];
    float ct[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (t0 + j < hi) {
        const int o = t0 + j - ws;
        raw[j] = load_raw<T, VE>(buf + (int64_t)o * k + c0);
        ct[j] = coef_s[o];
      }
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (t0 + j < hi) {
        float r[VE];
        unpack(raw[j], r);
#pragma unroll
        for (int i = 0; i < VE; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(ct[j], r[i]));
      }
  }
}

// Where the stages of a CTA's span come from: a stream layout, HvSpan's
// policy for where stage j of the span [s, e) starts (start; w0 is
// first(s)), where a stage that starts at ws ends at the latest (stop: the
// span's end aside), how many stages the span takes (stages), and how
// thread 0 copies a stage in (copy).  Whatever the layout, a stage holds
// its slot ws + i's row at row i of the buffer's (slots, k) rows and its
// weight at element i * kWStride of the weights after them, so the two
// phases of a stage are the same code for every layout.
//
// RowStream is the port's row-major stream (MAXC, k) per block, slot t's
// row at rows_b + t * k and its weight at w_b[t] (B1, B3, B4's row stage,
// B10): the span, widened to whole 8-slot groups, is cut into stages of
// `slots` slots, each one 1-D bulk copy of its rows and one of its weights
// (bulk copies need 16-byte-aligned addresses and sizes: MAXC % 8 == 0).
// Its walk is static: member calls on HvSpan's copy of the layout made
// nvcc give B1, B3 and B4 other registers (B4's row stage 64 at k = 32
// f32, not 56) for the same arithmetic.  The lane-packed stream of B9 is
// hv_variants.cu's PackedStream.
template <typename T>
struct RowStream {
  const T* rows_b;
  const T* w_b;
  static constexpr int kWStride = 1;

  __device__ __forceinline__ static int first(int s) { return s & ~7; }
  __device__ __forceinline__ static int stages(int s, int e, int slots) {
    return s < e ? (((e + 7) & ~7) - (s & ~7) + slots - 1) / slots : 0;
  }
  __device__ __forceinline__ static int start(int j, int w0, int, int,
                                              int slots) {
    return w0 + j * slots;
  }
  __device__ __forceinline__ static int stop(int ws, int slots) {
    return ws + slots;
  }

  // the slots [ws, min(ws + slots, w1)) of the span [., e), w1 = e widened
  // to 8 slots: their rows into buf and, kWeighted, their weights into
  // buf_w, completed on bar
  template <bool kWeighted>
  __device__ __forceinline__ void copy(T* buf, T* buf_w, uint64_t* bar,
                                       int ws, int e, int k,
                                       int slots) const {
    const int n = min(slots, ((e + 7) & ~7) - ws);  // a multiple of 8 slots
    const uint32_t row_bytes = (uint32_t)n * k * sizeof(T);
    const uint32_t col_bytes = kWeighted ? (uint32_t)n * sizeof(T) : 0u;
    mbar_expect_tx(bar, row_bytes + col_bytes);
    bulk_load(buf, rows_b + (int64_t)ws * k, row_bytes, bar);
    if constexpr (kWeighted) bulk_load(buf_w, w_b + ws, col_bytes, bar);
  }
};

// A CTA's share of the blocked stream on the staged path, and the stage
// loop over it (hv_rows: B1, B4's row stage and B9; B3's gap_rows_kernel;
// B10, whose CTA runs the spans of G blocks through one ring, run_from).
// CTA (b, y) owns the kRows rows [y * kRows, (y + 1) * kRows) of block b,
// a group of lanes per row; their runs are one contiguous span of slots
// [s, e), read from the static run pointer (no search).  Thread 0 streams
// the span through a ring of kStages stages of up to `slots` slots, cut
// and copied as the stream layout `Stream` says: each stage the slots'
// rows of the stream, then, kWeighted, their weights.  Each stage runs in
// two phases: (1) every group computes slot values of the stage
// (hv_stage_dots), (2) the caller's phase2(buf, ws, lo, hi) uses them, the
// values of slots [lo, hi) in coef_s[t - ws]; then the buffer is refilled.
// Dynamic shared memory, in order (bytes()): the ring, the rows' phi (f32,
// stride k + 4, so that the groups of a warp read different banks), a
// stage's slot values (f32) and the CTA's row runs.
template <typename T, int kRows, bool kWeighted,
          typename Stream = RowStream<T>>
struct HvSpan {
  // weight elements per slot of a stage
  static constexpr int kWCol = kWeighted ? Stream::kWStride : 0;
  T* ring;
  uint64_t* full;
  float* phi_s;
  float* coef_s;
  int* runs_s;
  Stream src;
  int k, kp, slots, elems;
  int s = 0, e = 0, w0 = 0, n_st = 0;

  static size_t bytes(int k, int slots) {
    return (size_t)kStages * slots * (k + kWCol) * sizeof(T) +
           ((size_t)kRows * (k + 4) + slots + kRows + 1) * sizeof(float);
  }

  __device__ __forceinline__ HvSpan(unsigned char* smem, uint64_t* full_,
                                    const Stream& src_, int k_, int slots_)
      : full(full_), src(src_), k(k_), kp(k_ + 4), slots(slots_),
        elems(slots_ * (k_ + kWCol)) {
    ring = reinterpret_cast<T*>(smem);
    phi_s = reinterpret_cast<float*>(ring + kStages * elems);
    coef_s = phi_s + kRows * kp;
    runs_s = reinterpret_cast<int*>(coef_s + slots);
  }

  // stage J of the ring into buffer J % kStages (thread 0): the stage that
  // starts at slot ws of the span [., e_) of the block that `from` reads
  __device__ __forceinline__ void issue_at(int J, const Stream& from,
                                           int ws, int e_) const {
    T* buf = ring + (J % kStages) * elems;
    from.template copy<kWeighted>(buf, buf + slots * k, &full[J % kStages],
                                  ws, e_, k, slots);
  }

  // stage j of the span into its buffer (thread 0)
  __device__ __forceinline__ void issue(int j) const {
    issue_at(j, src, src.start(j, w0, s, e, slots), e);
  }

  // the span of rows [r0, r0 + kRows) of the block whose runs are runs_b:
  // thread 0 initialises the barriers and issues the first stages, every
  // thread copies the CTA's runs (visible after the next __syncthreads)
  __device__ __forceinline__ void begin(const int* runs_b, int r0,
                                        int block_rows) {
    s = runs_b[r0];
    e = runs_b[min(r0 + kRows, block_rows)];
    w0 = src.first(s);
    n_st = src.stages(s, e, slots);
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
      mbar_init_fence();
      for (int j = 0; j < min(kStages, n_st); ++j) issue(j);
    }
    for (int i = threadIdx.x; i <= kRows; i += blockDim.x)
      runs_s[i] = runs_b[min(r0 + i, block_rows)];
  }

  // the row's phi (ph: the group's lanes' values, zero past k) into phi_s
  template <int G, int NV, int VE>
  __device__ __forceinline__ void keep_phi(int grp, int lane,
                                           const float (&ph)[NV][VE]) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (c0 < k)
#pragma unroll
        for (int i = 0; i < VE; ++i) phi_s[grp * kp + c0 + i] = ph[v][i];
    }
  }

  // The span's n_st stages, its first stage J0 of the ring: stage J in
  // buffer J % kStages, its barrier in phase J / kStages.  After each
  // stage thread 0 calls refill(J), which may issue stage J + kStages into
  // the buffer the stage freed.
  template <int G, int VE, typename Phase2, typename Refill>
  __device__ __forceinline__ void run_from(int J0, int lane, int grp,
                                           unsigned gmask, float w_scale,
                                           Phase2&& phase2,
                                           Refill&& refill) const {
    for (int j = 0; j < n_st; ++j) {
      const int J = J0 + j;
      mbar_wait(&full[J % kStages], (uint32_t)(J / kStages) & 1u);
      const int ws = src.start(j, w0, s, e, slots);
      const int lo = max(s, ws), hi = min(e, src.stop(ws, slots));
      const T* buf = ring + (J % kStages) * elems;
      hv_stage_dots<T, G, VE, kRows, kWeighted, Stream::kWStride>(
          buf, buf + slots * k, ws, lo, hi, k, lane, grp, gmask, w_scale,
          runs_s, phi_s, kp, coef_s);
      __syncthreads();  // the stage's slot values are written
      phase2(buf, ws, lo, hi);
      __syncthreads();  // every thread is done with buffer J % kStages
      if (threadIdx.x == 0) refill(J);
    }
  }

  // the span begun by begin(): a ring of its own
  template <int G, int VE, typename Phase2>
  __device__ __forceinline__ void run(int lane, int grp, unsigned gmask,
                                      float w_scale, Phase2&& phase2) const {
    run_from<G, VE>(0, lane, grp, gmask, w_scale, phase2, [&](int j) {
      if (j + kStages < n_st) issue(j + kStages);
    });
  }
};

// The end of a row of the blocked Hv (hv_rows; B10): the dense term
// acc[c] += phi[i] * dense[i, c], i ascending, phi from pr (the row's phi in
// shared memory), then the row written once at storage dtype.
template <typename T, int G, int NV, int VE>
__device__ __forceinline__ void hv_finish(const float* pr,
                                          const T* __restrict__ dense,
                                          T* __restrict__ out, int64_t row,
                                          int k, int lane,
                                          float (&acc)[NV][VE]) {
  constexpr bool kStaged = VE > 1;
  if constexpr (kStaged) {
    const int c0 = lane * VE;
    if (c0 < k) {
      for (int i0 = 0; i0 < k; i0 += 4) {  // k % 4 == 0 on this path
        const float4 p4 = *reinterpret_cast<const float4*>(pr + i0);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        RawVec<T, VE> raw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          raw[q] = load_raw<T, VE>(dense + (int64_t)(i0 + q) * k + c0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float dv[VE];
          unpack(raw[q], dv);
#pragma unroll
          for (int i = 0; i < VE; ++i)
            acc[0][i] = __fadd_rn(acc[0][i], __fmul_rn(pv[q], dv[i]));
        }
      }
    }
  } else {
    for (int i = 0; i < k; ++i) {
      const float pi = pr[i];
      const T* drow = dense + (int64_t)i * k;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c0 = (v * G + lane) * VE;
        if (c0 < k)
          acc[v][0] = __fadd_rn(acc[v][0], __fmul_rn(pi, to_f(drow[c0])));
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * G + lane) * VE;
    if (c0 < k) store_vals<T, VE>(out + row * k + c0, acc[v]);
  }
}

// The CTA body of B1, B4's row stage and B9: a group of G lanes per row
// (HvSpan above) of block blockIdx.x, whose stream `src` reads, each row's
// result written once at storage dtype.  On the staged path phase 2 of
// each stage has each row's group add its slots in order; the plain-load
// path (hv_slots, on the row-major stream) reads each row's run from
// device memory.  dense (k x k, 4 KB at k = 32 f32) is read through L1,
// which the SM's CTAs share.
template <typename T, int G, int NV, int VE, typename Phi, typename Stream>
__device__ __forceinline__ void hv_rows(const Phi& phi_of, const Stream& src,
                                        const int* __restrict__ runs,
                                        const T* __restrict__ dense,
                                        T* __restrict__ out, int k,
                                        int block_rows, float w_scale,
                                        int stage_slots) {
  constexpr int kRows = kHvThreads / G;
  constexpr bool kStaged = VE > 1;
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const unsigned gmask = group_mask<G>();
  const int64_t blk = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int r = r0 + grp;
  const bool live = r < block_rows;
  const int64_t row = blk * block_rows + r;
  const int* runs_b = runs + blk * (block_rows + 1);
  int rs = 0, re = 0;
  if (live) {
    rs = runs_b[r];
    re = runs_b[r + 1];
  }

  extern __shared__ __align__(128) unsigned char hv_smem[];
  __shared__ uint64_t full[kStages];
  HvSpan<T, kRows, true, Stream> sp(hv_smem, full, src, k, stage_slots);
  if constexpr (kStaged) sp.begin(runs_b, r0, block_rows);

  // while the first stages are in flight: the row's phi, into registers
  // and shared memory
  float ph[NV][VE];
  phi_of.template load<G, NV, VE>(live, row, lane, ph);
  sp.template keep_phi<G, NV, VE>(grp, lane, ph);
  __syncthreads();  // phi, the runs and the initialised barriers are visible

  float acc[NV][VE];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[v][i] = 0.f;
  if constexpr (!kStaged) {
    hv_slots<T, G, NV, VE>(src.rows_b, src.w_b, rs, re, k, lane, gmask,
                           w_scale, ph, acc);
  } else {
    sp.template run<G, VE>(
        lane, grp, gmask, w_scale, [&](const T* buf, int ws, int, int) {
          if (lane * VE < k)
            hv_stage_adds<T, VE>(buf, sp.coef_s, ws, max(rs, ws),
                                 min(re, src.stop(ws, stage_slots)), k,
                                 lane * VE, acc[0]);
        });
  }
  if (!live) return;
  hv_finish<T, G, NV, VE>(sp.phi_s + grp * sp.kp, dense, out, row, k, lane,
                          acc);
}

// The launch geometry of an HvSpan kernel (kHvThreads threads) on plan
// (G, VE) and stream layout `Stream`: grid (n_blocks, slices of kRows
// rows), slots per stage (staged path) and dynamic shared memory (under 25
// KB for every plan of hv_rows, B3 and B9, so no opt-in above the default
// 48 KB).
struct HvGrid {
  dim3 grid;
  int stage_slots;
  size_t smem;
};

template <typename T, int G, int VE, bool kWeighted,
          typename Stream = RowStream<T>>
inline HvGrid hv_grid(long long n_blocks, int k, int block_rows,
                      int stage_bytes = kStageBytes) {
  constexpr int kRows = kHvThreads / G;
  const int slots =
      VE > 1 ? stage_slots_for(k * (int)sizeof(T), stage_bytes) : 0;
  return {dim3((unsigned)n_blocks, (block_rows + kRows - 1) / kRows), slots,
          HvSpan<T, kRows, kWeighted, Stream>::bytes(k, slots)};
}

// the staged path of an HvSpan kernel applies: whole 16-byte vectors per
// row, k <= 32 (one lane sum per column), aligned bases (the stream, the
// weights, dense, phi or V, the output) and MAXC % 8 == 0 (the bulk copies
// start at 8-slot boundaries of each block's MAXC slots)
inline bool hv_staged(int k, int maxc, int elem_bytes, const void* const* ptrs,
                      int n) {
  return k <= 32 && maxc % 8 == 0 && vec_ok(k, elem_bytes, ptrs, n);
}

// ---------------------------------------------------------------------------
// Rows projected by groups of lanes (B8, and B6's row stage): each group of
// G lanes walks the rows g, g + n_groups, ... of a grid of as many CTAs as
// the SMs hold at once, and projects each row with ProjectedPhi on the
// kernel's width plan.  While a batch's table rows are in flight the group
// loads the (id, value) slots of its next batch (the same row's, or the
// first of its next row), so a row's dependent chain is its table rows'
// latency, not the slot loads' before it.  `Row` is the kernel's own part:
// begin() issues its loads of the row (B6: Q1[row] and dd[row]) with the
// first table rows, end() finishes the row from phi (B8: a vector store of
// the row; B6: the dot with Q1[row], the scale s and its store).
//
// What held the warp per row back (one warp per row, one row per warp: on
// FFM's 200,000 u rows ~24 waves of 8-warp CTAs), and what this does:
// - 32 lanes for a row, each with eight generic values (k <= 256), seven of
//   them zero at k = 32: a group of G lanes per row on a width plan fixed
//   at compile time (by_width), so at k = 32 a warp serves 4 rows (f32: 8
//   lanes x one float4) or 8 (bf16: 4 lanes x 8 values);
// - per row a chain of latencies (the slot loads, a shuffle per slot, one
//   table row after the other, the store): the next batch's slots load
//   under the current table rows, whose loads all issue before their adds;
// - 4 bytes stored per lane: one 16-byte store per lane.
// ---------------------------------------------------------------------------

// The launch of project_rows: 256-thread CTAs held to 4 per SM (at most 64
// registers per thread), each group walking its rows one at a time.  On
// the H100 at k = 32, FFM's and FM's shapes, f32 and bf16, this ran B8 and
// B6 as fast as any of 128- to 512-thread CTAs, and a little faster than
// the same CTAs without the hold (B6's kernel then takes 66 registers: 3
// CTAs per SM); holding 6 or 8 CTAs per SM (40 or 32 registers) spilled
// and ran 2-3x slower, and a grid of a row per group, with no walk, ran
// the v sides and FM's u side slower than the grid of resident CTAs.
constexpr int kProjThreads = 256;  // threads per CTA
constexpr int kProjCtas = 4;       // CTAs per SM (__launch_bounds__)

template <typename T, int G, int NV, int VE, typename Row>
__device__ __forceinline__ void project_rows(const ProjectedPhi<T>& pj,
                                             const Row& rw, int64_t n_rows) {
  constexpr int P = ProjectedPhi<T>::template batch<NV>();
  constexpr int kGroups = kProjThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t step = (int64_t)gridDim.x * kGroups;
  int64_t row = (int64_t)blockIdx.x * kGroups + threadIdx.x / G;
  SlotBatch<P> cur;
  pj.slots(row < n_rows, row, 0, cur);
  for (; row < n_rows; row += step) {
    typename Row::template Held<NV, VE> held;
    rw.template begin<G, NV, VE>(row, lane, held);
    float acc[NV][VE];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[v][i] = 0.f;
    for (int s0 = 0; s0 < pj.p; s0 += P) {
      RawVec<T, VE> raw[P][NV];
      pj.template gather<G, NV, VE>(cur, lane, raw);
      SlotBatch<P> nxt;
      if (s0 + P < pj.p) {
        pj.slots(true, row, s0 + P, nxt);
      } else {
        pj.slots(row + step < n_rows, row + step, 0, nxt);
      }
      pj.template add<G, NV, VE>(cur, raw, lane, acc);
      cur = nxt;
    }
    float ph[NV][VE];
    pj.template rounded<G, NV, VE>(acc, lane, ph);
    rw.template end<G, NV, VE>(row, lane, ph, held);
  }
}

// CTAs of a project_rows kernel that the SMs hold at once
template <typename K>
inline long long resident_ctas(K kernel) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kProjThreads,
                                                0);
  return (long long)n_sm * (per_sm > 0 ? per_sm : 1);
}

// The grid of a project_rows kernel over n_rows: a row per group, capped at
// the resident CTAs (the groups then walk rows in turn).
inline unsigned proj_grid(long long n_rows, int G, long long resident) {
  const long long per_cta = kProjThreads / G;
  const long long want = (n_rows + per_cta - 1) / per_cta;
  return (unsigned)(want < resident ? (want > 0 ? want : 1) : resident);
}

// ---------------------------------------------------------------------------
// The end of a chunk of a chunked list, shared by the X^T stage
// (table_ops.cu xt_body, over a field's feature-major list) and
// coo_list_kernel (coo_ops.cu, over a COO side's destination-major list of
// the positive stream), where a group of G lanes sums each chunk.  A chunk
// of a single-chunk feature writes its sums straight to the feature's row
// (the two-stage order adds them to 0.f, which gives the same bits: a sum
// starts at +0 and so is never -0).  A chunk of a feature with several
// writes its f32 partial row, and the group that finishes the feature's
// last chunk (in time: a ticket per feature, counted after a memory fence,
// as in CUDA's threadFenceReduction sample) adds the feature's partial rows
// in chunk order and resets the ticket for the next launch:
//   out[f] = 0 + partial[p0] + partial[p0 + 1] + ...                 (f32)
// No float atomics: the same bits on every run.  The partial rows, which
// other SMs write during a launch, are read through L2.
// ---------------------------------------------------------------------------

// a list's chunks and combine plan (ops/layout.py xt_plan) and the launch's
// scratch: NOUT * k floats per partial row (chunk_dst >= 0), one ticket per
// feature, zero before and after each launch
struct ChunkPlan {
  const int *chunk_ptr, *chunk_dst;
  int n_chunks;
  const int *feat_ptr, *combine;
  int n_combine;
  const int* slot_feat;
  int* ticket;
  float* partial;
};

template <int NOUT, int NV, int VE>
__device__ __forceinline__ void zero_sums(float (&acc)[NOUT][NV][VE]) {
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[o][v][i] = 0.f;
}

// Ends chunk `ch` (chunk_dst code `dst`) with its NOUT sums `acc`: a
// single-chunk feature's row, or the chunk's partial row and, for the
// group that draws the feature's last ticket, the feature's row from its
// partial rows in chunk order.  body.store(f, sums) writes feature f's
// row.
template <int G, int NV, int VE, int NOUT, class Body>
__device__ __forceinline__ void chunk_finish(const ChunkPlan& p, int ch,
                                             int dst,
                                             const float (&acc)[NOUT][NV][VE],
                                             int k, int lane, unsigned gmask,
                                             const Body& body) {
  constexpr int DC = 4;  // partial rows per batch of the finishing adds
  if (dst < 0) {
    body.store(-1 - dst, acc);
    return;
  }
  float* pp = p.partial + (int64_t)dst * NOUT * k;
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (c0 < k) store_f32<VE>(pp + o * k + c0, acc[o][v]);
    }
  __threadfence();
  __syncwarp(gmask);
  int f = 0, last = 0;
  if (lane == 0) {
    f = p.slot_feat[dst];
    last = atomicAdd(p.ticket + f, 1) ==
           p.feat_ptr[f + 1] - p.feat_ptr[f] - 1;
  }
  last = __shfl_sync(gmask, last, 0, G);
  if (!last) return;
  f = __shfl_sync(gmask, f, 0, G);
  __threadfence();
  const int c_first = p.feat_ptr[f];
  const int n = p.feat_ptr[f + 1] - c_first;
  const float* p0 = p.partial + (int64_t)(dst - (ch - c_first)) * NOUT * k;
  float sum[NOUT][NV][VE];
  zero_sums(sum);
  for (int b0 = 0; b0 < n; b0 += DC) {
    float q[DC][NOUT][NV][VE];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (b0 + j < n) {
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c0 = (v * G + lane) * VE;
            if (c0 < k)
              load_f32_cg<VE>(p0 + ((int64_t)(b0 + j) * NOUT + o) * k + c0,
                              q[j][o][v]);
          }
      }
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (b0 + j < n) {
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if ((v * G + lane) * VE >= k) continue;
#pragma unroll
            for (int i = 0; i < VE; ++i)
              sum[o][v][i] = __fadd_rn(sum[o][v][i], q[j][o][v][i]);
          }
      }
  }
  body.store(f, sum);
  if (lane == 0) p.ticket[f] = 0;  // ready for the next launch
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
