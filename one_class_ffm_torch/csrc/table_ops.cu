// Hopper (sm_90a) kernels for the fused table-space passes of a solve on
// a small-D feature field (D <= 4096): the cross-block Hv and gradient and
// the self-block Hv and gradient, the two gradients optionally with the
// Jacobi diagonal's term, a second per-row payload from the same stage 1
// that stage 2 scatters through the field's X^2 (its feature-major list's
// squared values).  Built with the other sources into one
// shared library (ops/kernels.py), bound with ctypes.  Stage 2 below, the
// X^T stage, is also the general scatter G = X^T Z of a wide field
// (ops/sparse_ops.py scatter); stage 1's phi = X V is B8's projection
// (common.cuh ProjectedPhi).
//
// The TPU kernels keep the (D, k) table-space output in VMEM across a
// sequential grid over row blocks (out_ref[...] += X_b^T payload_b).  Here
// blocks run in parallel and in no order, and a (4096, 32) f32 table does
// not fit in one block's shared memory, so each pass runs in two stages:
//
//   1. rows: a group of lanes per data row on a width plan (B4: common.cuh
//      hv_rows; B6: common.cuh project_rows; B5: B2's runs-and-stages body,
//      blocked_ops.cu grad_cross_rows_kernel), a thread per data row (B7).
//      It computes the row's payload from the row's X entries, the table V
//      (read through L2), the blocked positive stream and the dense terms,
//      and writes it once at storage
//      dtype: the same single rounding the TPU kernels apply to their zpb /
//      zb block.  phi = X V never leaves the CTA.  B6's and B7's payloads
//      are storage(s_i * Q1[i]) with one scalar s_i per row (B7: zb_i): their
//      row stages write the scalar alone, and the X^T stage forms each
//      gathered payload row from Q1[row] and the scalar (the same product,
//      rounded once: the same bits), as the TPU kernels never write their
//      zpb / zb out either; B7's Jacobi payload depends on Q1 and dd alone
//      and is formed there too.
//   2. X^T payload: over the field's static feature-major list
//      (ops/layout.py FeatureMajor) and its plan (layout.xt_plan), in one
//      launch.  A group of lanes per chunk of at most XT_CHUNK entries of
//      one feature sums val * payload[row] in list order at f32.  The chunk
//      of a feature that has only one writes its sum straight to the
//      output; the chunks of the other features write partial rows, and
//      the group that finishes a feature's last chunk adds its partials in
//      chunk order.  Features with no entries get a zero row.  The chunks
//      split the few heavy features (class bases carrying ~25k rows each)
//      over many groups.
//
// No float atomics: every sum runs in a fixed order, so two launches give
// the same bits and the plain versions in ops/sparse_ops.py, which add in
// the same order with the same roundings (no fused multiply-add), agree
// with the kernels bit for bit.  (An integer ticket per feature picks
// which group adds a feature's partial rows, not the order it adds them.)
//
// Bounds on the H100: stage 1 streams the blocked stream `rows` once (as
// B1/B2 do) and reads each data row's p table rows from L2 (D x k is at
// most 512 KB); it is bound by device-memory bandwidth.  Stage 2 gathers
// one payload row (k values, 128 bytes at k=32 f32; for B6 and B7 a Q1
// row and its scale) per X entry and writes one output row per feature: on
// FM's u field 600k random 128-byte reads and a 26 MB output, bound by
// device-memory bandwidth once enough reads are in flight, by latency
// otherwise.  What the design does about it:
//   - most of FM's features (ids) have one entry and so one chunk; their
//     sums go straight to the output, with no partial row written and read
//     back and no pass over every feature;
//   - a short chunk gets a group of G lanes, not a warp: at k = 32 one
//     16-byte load per lane covers a row with 8 lanes (f32) or 4 (bf16),
//     so a warp serves 4 or 8 chunks;
//   - a batch of D payload rows is loaded before the first of its ordered
//     adds, and the next batch's (row, val) while they are in flight, so a
//     128-entry chunk is 32 round trips to memory (D = 4), not 128;
//   - the width is a template argument (common.cuh by_width), so a lane
//     holds k / G values in registers, not eight generic ones (B9's
//     lesson: registers set occupancy in these latency-bound loops);
//   - one launch, not two: a short scatter (FM's item field, 60k entries)
//     costs about as much host time as device time.
// Gathers of random payload rows gain nothing from TMA or tensor cores.

#include "common.cuh"

using namespace ocffm;

namespace {

// Stage 1 of pos_hv_tbl, replacing pos_hv_tbl_pallas / _hv_tbl_kernel and
// its k-major twin pos_hv_tbl_kt_pallas / _hv_tbl_kt_kernel
// (one_class_ffm_tpu/ops/sparse_ops.py).  For row r of block b:
//   payload[r] = storage(B1 math on phib),   phib = storage(X_r V)
// on B1's CTA body (common.cuh hv_rows), the row's group projecting its own
// phib first (ProjectedPhi: B8's bits); it was the largest device
// op of the FFM epoch as a warp per row.
template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kHvThreads)
hv_tbl_rows_kernel(const T* __restrict__ V, const int* __restrict__ xi,
                   const T* __restrict__ xv, int p, int d,
                   const T* __restrict__ rows, const int* __restrict__ runs,
                   const T* __restrict__ w, const T* __restrict__ dense,
                   T* __restrict__ payload, int maxc, int k, int block_rows,
                   float w_scale, int stage_slots) {
  const int64_t blk = blockIdx.x;
  hv_rows<T, G, NV, VE>(ProjectedPhi<T>{V, xi, xv, p, d, k},
                        RowStream<T>{rows + blk * maxc * k, w + blk * maxc},
                        runs, dense, payload, k, block_rows, w_scale,
                        stage_slots);
}

template <typename T>
struct HvTblLaunch {
  const T* V;
  const int* xi;
  const T* xv;
  int p, d;
  const T* rows;
  const int* runs;
  const T *w, *dense;
  T* payload;
  long long n_blocks;
  int maxc, k, block_rows;
  float w_scale;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    if constexpr (VE > 1 && G * NV * VE > 32) {
      return (int)cudaErrorInvalidValue;  // hv_staged admits k <= 32 only
    } else {
      const HvGrid g = hv_grid<T, G, VE, true>(
          n_blocks, k, block_rows);
      hv_tbl_rows_kernel<T, G, NV, VE><<<g.grid, kHvThreads, g.smem, st>>>(
          V, xi, xv, p, d, rows, runs, w, dense, payload, maxc, k,
          block_rows, w_scale, g.stage_slots);
      return (int)cudaGetLastError();
    }
  }
};

// Stage 1 of hv_self_tbl, replacing hv_self_tbl_pallas / _hv_self_tbl_kernel
// and hv_self_tbl_kt_pallas.  For row i:
//   s_i = storage(dd_i * storage(<Q1[i], phib_i>)),  phib = storage(X_i V)
// Bound on the H100: bytes, Q1 and X's rows read once and s written (~31
// MB on FFM's u field at k = 32 f32).  The warp per row it replaces spent
// a chain of latencies per row and warp (~24 waves of 8-warp CTAs there)
// and wrote a 128-byte payload row per row; this runs on B8's group-per-row
// body (common.cuh project_rows): the group projects phib, loads Q1[i] and
// dd_i with the first table rows, folds the dot in _lane_dot's order with
// lane_tree and writes s_i alone (the X^T stage forms the payload rows from
// Q1 and s, which ran faster on the card than writing them here and
// gathering them back).  Its width plan is hv_rows' rule: 16-byte vectors only where G *
// VE <= 32 (k <= 32), so that a lane's values are _lane_dot's lane sums,
// else the plain-load plan (G = 32, VE = 1: lane l sums columns l, l + 32,
// ... in turn).
template <typename T>
struct SelfScale {
  const T* q1;
  const T* dd;
  T* s;
  int k;
  template <int NV, int VE>
  struct Held {
    RawVec<T, VE> q[NV];
    float dd;
  };
  template <int G, int NV, int VE>
  __device__ __forceinline__ void begin(int64_t row, int lane,
                                        Held<NV, VE>& h) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (c0 < k) h.q[v] = load_raw<T, VE>(q1 + row * k + c0);
    }
    h.dd = to_f(dd[row]);
  }
  template <int G, int NV, int VE>
  __device__ __forceinline__ void end(int64_t row, int lane,
                                      const float (&ph)[NV][VE],
                                      const Held<NV, VE>& h) const {
    static_assert(NV == 1 || G * VE == 32, "lane l sums columns l + 32 j");
    // the tree's leaves: lane l's products of columns l, l + 32, ... in
    // turn (_lane_dot's lane sums, no +0 start); products past k are +0
    float q[NV][VE], x[1][VE];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if ((v * G + lane) * VE < k) {
        unpack(h.q[v], q[v]);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) q[v][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const float pr = __fmul_rn(q[v][i], ph[v][i]);
        if (v == 0) {
          x[0][i] = pr;
        } else if (v * G * VE < k) {
          x[0][i] = __fadd_rn(x[0][i], pr);
        }
      }
    }
    lane_tree<G, VE, 1>(x, group_mask<G>());
    if (lane == 0) s[row] = from_f<T>(__fmul_rn(h.dd, rnd<T>(x[0][0])));
  }
};

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kProjThreads, kProjCtas)
hv_self_scale_kernel(ProjectedPhi<T> pj, SelfScale<T> rw, int64_t n_rows) {
  project_rows<T, G, NV, VE>(pj, rw, n_rows);
}

template <typename T>
struct HvSelfLaunch {
  ProjectedPhi<T> pj;
  SelfScale<T> rw;
  long long n_rows;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    if constexpr (VE > 1 && G * NV * VE > 32) {
      return (int)cudaErrorInvalidValue;  // the vector plan: k <= 32 only
    } else {
      static const long long resident =
          resident_ctas(hv_self_scale_kernel<T, G, NV, VE>);
      const unsigned grid = proj_grid(n_rows, G, resident);
      hv_self_scale_kernel<T, G, NV, VE><<<grid, kProjThreads, 0, st>>>(
          pj, rw, n_rows);
      return (int)cudaGetLastError();
    }
  }
};

// Stage 1 of grad_self_tbl, replacing grad_self_tbl_pallas /
// _grad_self_tbl_kernel and grad_self_tbl_kt_pallas.  Its payload row
// storage(zb_r * Q1[r]) has B6's form, one scale per row times Q1, so the
// row stage writes the scale alone, at storage dtype, one thread per row:
//   zb_r = storage(zdense[r] + z_r),  z_r = 0 + c_s + ... + c_{e-1}
// the row's run [s, e) of slot coefficients added in slot order at f32
// (_run_sums' order), the run read from the static run pointer `runs`.
// The X^T stage forms storage(zb[row] * Q1[row]) per gathered entry
// (xt_scaled_kernel), and for the Jacobi dd output storage(storage(dd[row]
// * Q1[row]) * Q1[row]) through the field's X^2 (xt_scaled_sq_kernel): no
// payload row is written.  Bound on the H100: bytes, the coefficients, the
// runs, zdense and zb (~6 MB on FFM's u side at f32).  The warp per row it
// replaces found each run by two binary searches over the owners, had its
// 32 lanes add the same run, and wrote a 128-byte payload row per row
// (25.6 MB, and as much again for the Jacobi payload) that the X^T stage
// gathered back.  Each thread loads a batch of kZbBatch slots before their
// ordered adds (runs of 4.4 slots on the u side, 44 on the v side); the
// warp's runs are one contiguous span of slots, so its loads share lines.
constexpr int kZbThreads = 256;
constexpr int kZbBatch = 8;

template <typename T>
__global__ void __launch_bounds__(kZbThreads)
grad_self_scale_kernel(const T* __restrict__ zdense,
                       const int* __restrict__ runs, const T* __restrict__ c,
                       T* __restrict__ zb, int64_t n_rows, int maxc,
                       int block_rows) {
  const int64_t row = (int64_t)blockIdx.x * kZbThreads + threadIdx.x;
  if (row >= n_rows) return;
  const int64_t blk = row / block_rows;
  const int r = (int)(row - blk * block_rows);
  const int* runs_b = runs + blk * (block_rows + 1);
  const int s = runs_b[r], e = runs_b[r + 1];
  const T* c_b = c + blk * maxc;
  float z = 0.f;
  for (int t0 = s; t0 < e; t0 += kZbBatch) {
    float ct[kZbBatch];
#pragma unroll
    for (int j = 0; j < kZbBatch; ++j)
      if (t0 + j < e) ct[j] = to_f(c_b[t0 + j]);
#pragma unroll
    for (int j = 0; j < kZbBatch; ++j)
      if (t0 + j < e) z = __fadd_rn(z, ct[j]);
  }
  zb[row] = from_f<T>(__fadd_rn(to_f(zdense[row]), z));
}

// Stage 2, shared by the four passes and the general scatter: one launch,
// one group of G lanes per chunk (grid-stride), the chunk's entries
// gathered in batches of D payload rows whose loads are all in flight
// before their ordered adds, the next batch's (row, val) loaded while they
// are:
//   sum = 0 + val_s * payload[row_s] + ... in list order           (f32)
// The payload row comes from a source fixed at compile time (XtSource):
// payload[row] (kPayload, xt_kernel: B4, B5, the general scatter);
// storage(scale[row] * payload[row]) (kScaled, xt_scaled_kernel: B6 with
// scale = s, B7 with scale = zb, payload = Q1); storage(storage(scale[row]
// * payload[row]) * payload[row]) (kScaledSq, xt_scaled_sq_kernel: B7's
// Jacobi payload with scale = dd, payload = Q1, through X^2).  Each is
// formed per gathered entry with the roundings of the payload row a row
// stage would have stored, so the same bits.  The chunk ends in
// common.cuh chunk_finish (a multi-chunk feature's partial rows added in
// chunk order), as coo_list_kernel's do; the grid-stride loop and the
// batches stay here: on coo_list_kernel's (coo_ops.cu list_pass,
// gather_rows) B6's and B7's scaled source ran 1.6-1.9x slower on the H100.
// The items after the chunks give the features with no entries a zero row.
// D is half of B2's batch (4 rows at k = 32 f32), the finishing adds take 4
// partial rows per batch, and the kernel is held to 3 CTAs per SM (at most
// 85 registers): on the H100 at k = 32 f32 that ran FM's and FFM's lists
// fastest of the batch depths (4, 8, 16) and CTA counts per SM (1 to 4)
// tried; holding the (row, val) pairs across the group's lanes and
// shuffling them out per entry was slower than any of them.
enum XtSource { kPayload, kScaled, kScaledSq };

// chunk_finish's body for the X^T stage: a feature's row stored at f32
template <int G, int NV, int VE>
struct XtOut {
  float* out;
  int k;
  __device__ __forceinline__ void store(int f,
                                        const float (&sum)[1][NV][VE]) const {
    const int lane = threadIdx.x % G;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (c0 < k) store_f32<VE>(out + (int64_t)f * k + c0, sum[0][v]);
    }
  }
};

template <typename T, int G, int NV, int VE, XtSource kSrc>
__device__ __forceinline__ void xt_body(
    const T* __restrict__ payload, const T* __restrict__ scale,
    const int* __restrict__ xf_row, const T* __restrict__ xf_val,
    const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_dst, int n_chunks,
    const int* __restrict__ feat_ptr,
    const int* __restrict__ combine, int n_combine,
    const int* __restrict__ slot_feat, int* __restrict__ ticket,
    float* __restrict__ partial, float* __restrict__ out, int k) {
  constexpr int kGroups = kWarps * 32 / G;
  constexpr int D0 = batch_depth<T, NV, VE>() > 4
                         ? batch_depth<T, NV, VE>() / 2
                         : 2;
  // kScaledSq keeps each loaded value beside its scaled product: half the
  // batch where a lane's values outnumber four (bf16, or NV > 1), so that
  // it fits the 85 registers without a stack
  constexpr bool kSq = kSrc == kScaledSq;
  constexpr int D = kSq && VE * NV > 4 ? D0 / 2 : D0;
  // the per-row scale of kScaled / kScaledSq, read at the payload row
  constexpr bool kRowScale = kSrc == kScaled || kSrc == kScaledSq;
  const ChunkPlan plan{chunk_ptr, chunk_dst, n_chunks, feat_ptr, combine,
                       n_combine, slot_feat, ticket, partial};
  const XtOut<G, NV, VE> out_rows{out, k};
  const int lane = threadIdx.x % G;
  // the group's lanes (a warp's groups may run chunks of other lengths)
  const unsigned gmask =
      G == 32 ? kFull
              : ((1u << (G & 31)) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int n_groups = gridDim.x * kGroups;
  for (int it = blockIdx.x * kGroups + threadIdx.x / G;
       it < n_chunks + n_combine; it += n_groups) {
    float acc[1][NV][VE];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[0][v][i] = 0.f;
    if (it >= n_chunks) {  // a featureless feature's zero row
      const int f = combine[it - n_chunks];
      if (feat_ptr[f + 1] == feat_ptr[f]) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * G + lane) * VE;
          if (c0 < k) store_f32<VE>(out + (int64_t)f * k + c0, acc[0][v]);
        }
      }
      continue;
    }
    const int ch = it;
    const int s = chunk_ptr[ch], e = chunk_ptr[ch + 1], dst = chunk_dst[ch];
    int row_c[D];
    float val_c[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (s + j < e) {
        row_c[j] = xf_row[s + j];
        val_c[j] = to_f(xf_val[s + j]);
      }
    for (int b0 = s; b0 < e; b0 += D) {
      RawVec<T, VE> raw[D][NV];
      float sc[D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (b0 + j < e) {
          const T* pr = payload + (int64_t)row_c[j] * k;
          if constexpr (kRowScale) sc[j] = to_f(scale[row_c[j]]);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int c0 = (v * G + lane) * VE;
            if (c0 < k) raw[j][v] = load_raw<T, VE>(pr + c0);
          }
        }
      int row_n[D];
      float val_n[D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (b0 + D + j < e) {
          row_n[j] = xf_row[b0 + D + j];
          val_n[j] = to_f(xf_val[b0 + D + j]);
        }
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (b0 + j < e) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if ((v * G + lane) * VE >= k) continue;
            float f[VE];
            unpack(raw[j][v], f);
            if constexpr (kSrc == kScaled) {
#pragma unroll
              for (int i = 0; i < VE; ++i)
                f[i] = rnd<T>(__fmul_rn(sc[j], f[i]));
            } else if constexpr (kSrc == kScaledSq) {
#pragma unroll
              for (int i = 0; i < VE; ++i)
                f[i] = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(sc[j], f[i])), f[i]));
            }
#pragma unroll
            for (int i = 0; i < VE; ++i)
              acc[0][v][i] = __fadd_rn(acc[0][v][i], __fmul_rn(val_c[j], f[i]));
          }
        }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        row_c[j] = row_n[j];
        val_c[j] = val_n[j];
      }
    }
    chunk_finish<G, NV, VE, 1>(plan, ch, dst, acc, k, lane, gmask, out_rows);
  }
}

#define OCFFM_XT_PARAMS                                                    \
  const T *__restrict__ payload, const T *__restrict__ scale,              \
      const int *__restrict__ xf_row, const T *__restrict__ xf_val,        \
      const int *__restrict__ chunk_ptr,                                   \
      const int *__restrict__ chunk_dst, int n_chunks,                     \
      const int *__restrict__ feat_ptr,                                    \
      const int *__restrict__ combine, int n_combine,                      \
      const int *__restrict__ slot_feat, int *__restrict__ ticket,         \
      float *__restrict__ partial, float *__restrict__ out, int k
#define OCFFM_XT_ARGS                                                     \
  payload, scale, xf_row, xf_val, chunk_ptr, chunk_dst, n_chunks,         \
      feat_ptr, combine, n_combine, slot_feat, ticket, partial, out, k

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kWarps * 32, 3) xt_kernel(OCFFM_XT_PARAMS) {
  xt_body<T, G, NV, VE, kPayload>(OCFFM_XT_ARGS);
}

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kWarps * 32, 3)
xt_scaled_kernel(OCFFM_XT_PARAMS) {
  xt_body<T, G, NV, VE, kScaled>(OCFFM_XT_ARGS);
}

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kWarps * 32, 3)
xt_scaled_sq_kernel(OCFFM_XT_PARAMS) {
  xt_body<T, G, NV, VE, kScaledSq>(OCFFM_XT_ARGS);
}

template <typename T>
struct XtLaunch {
  const T *payload, *scale;
  const int* xf_row;
  const T* xf_val;
  const int *chunk_ptr, *chunk_dst;
  int n_chunks;
  const int *feat_ptr, *combine;
  int n_combine;
  const int* slot_feat;
  int* ticket;
  float *partial, *out;
  int k;
  XtSource src;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    const unsigned grid = group_grid((long long)n_chunks + n_combine, G);
    switch (src) {
      case kPayload:
        xt_kernel<T, G, NV, VE><<<grid, kWarps * 32, 0, st>>>(OCFFM_XT_ARGS);
        break;
      case kScaled:
        xt_scaled_kernel<T, G, NV, VE><<<grid, kWarps * 32, 0, st>>>(
            OCFFM_XT_ARGS);
        break;
      case kScaledSq:
        xt_scaled_sq_kernel<T, G, NV, VE><<<grid, kWarps * 32, 0, st>>>(
            OCFFM_XT_ARGS);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// runs: (n_blocks, block_rows + 1) row runs of slots
int ocffm_pos_hv_tbl_rows(int dtype, const void* V, const void* xi,
                          const void* xv, int p, int d, const void* rows,
                          const void* runs, const void* w, const void* dense,
                          void* payload, long long n_blocks, int maxc, int k,
                          int block_rows, float w_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const void* ptrs[] = {V, rows, w, dense, payload};
  const bool staged = hv_staged(k, maxc, dtype == kF32 ? 4 : 2, ptrs, 5);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, staged, HvTblLaunch<T>{
      (const T*)V, (const int*)xi, (const T*)xv, p, d, (const T*)rows,
      (const int*)runs, (const T*)w, (const T*)dense, (T*)payload, n_blocks,
      maxc, k, block_rows, w_scale, st}));
}

// s (rows,) at storage dtype: each row's scale of Q1[row]
int ocffm_hv_self_tbl_rows(int dtype, const void* V, const void* xi,
                           const void* xv, int p, int d, const void* q1,
                           const void* dd, void* s, long long n_rows, int k,
                           void* stream) {
  const void* ptrs[] = {V, q1};
  const bool vec = k <= 32 && vec_ok(k, dtype == kF32 ? 4 : 2, ptrs, 2);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec, HvSelfLaunch<T>{
      {(const T*)V, (const int*)xi, (const T*)xv, p, d, k},
      {(const T*)q1, (const T*)dd, (T*)s, k}, n_rows,
      (cudaStream_t)stream}));
}

// zb (n_rows,) at storage dtype: each row's scale of Q1[row];
// runs: (n_blocks, block_rows + 1) row runs of slots
int ocffm_grad_self_tbl_rows(int dtype, const void* zdense, const void* runs,
                             const void* c, void* zb, long long n_rows,
                             int maxc, int block_rows, void* stream) {
  const unsigned grid = (unsigned)((n_rows + kZbThreads - 1) / kZbThreads);
  OCFFM_BY_DTYPE(dtype, grad_self_scale_kernel<T><<<grid, kZbThreads, 0,
                                                    (cudaStream_t)stream>>>(
      (const T*)zdense, (const int*)runs, (const T*)c, (T*)zb, n_rows, maxc,
      block_rows));
  return (int)cudaGetLastError();
}

// out (d, k) f32 = X^T payload through the feature-major list and its plan
// (combine, chunk_dst, slot_feat); source 0: the payload rows; 1 (B6, B7)
// storage(scale[row] * payload[row]) per entry; 2 (B7's Jacobi payload)
// storage(storage(scale[row] * payload[row]) * payload[row]).  `partial`
// holds a row of k floats for each chunk whose chunk_dst is >= 0; `ticket`
// holds one int per feature, zero before and after each launch.
int ocffm_xt_scatter(int dtype, const void* payload, const void* scale,
                     int source, const void* xf_row, const void* xf_val,
                     const void* chunk_ptr, const void* chunk_dst,
                     int n_chunks, const void* feat_ptr, const void* combine,
                     int n_combine, const void* slot_feat, void* ticket,
                     int k, void* partial, void* out, void* stream) {
  if (n_chunks + n_combine == 0) return 0;
  if (source < kPayload || source > kScaledSq ||
      (source != kPayload && scale == nullptr) || xf_val == nullptr ||
      payload == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {payload, out, partial};
  const bool vec = vec_ok(k, dtype == kF32 ? 4 : 2, ptrs, 3);
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec, XtLaunch<T>{
      (const T*)payload, (const T*)scale, (const int*)xf_row,
      (const T*)xf_val, (const int*)chunk_ptr, (const int*)chunk_dst,
      n_chunks, (const int*)feat_ptr, (const int*)combine, n_combine,
      (const int*)slot_feat, (int*)ticket, (float*)partial, (float*)out, k,
      (XtSource)source, st}));
}

}  // extern "C"
