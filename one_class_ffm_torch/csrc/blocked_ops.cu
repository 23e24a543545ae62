// Hopper (sm_90a) kernels for the blocked positive-stream passes of a
// cross-block solve on an identity or wide field (B1-B3; B2 also with the
// Jacobi diagonal's payload), and B2's body with a dense term, the row
// stage of the fused cross gradient B5 (whose X^T stage is table_ops.cu's).
// Built by
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
// come last, so the slots of one row form one contiguous run.  B1-B3 read
// each row's run from the static run pointer `runs` (layout.row_runs, built
// once with the layout); B3's plain-load path reads each slot's owner.  The
// per-row sums need no atomics and run in a fixed order: two launches on
// the same input give the same bits.
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
// tensor cores.  Each brings its CTA's span of the stream into shared
// memory with bulk copies (common.cuh) and reads it exactly once; phi/dP
// rows are read once per row, out once per row or slot.  Offsets are
// 64-bit: n_blocks * MAXC * k passes 2^31 at web-scale configurations.

#include "common.cuh"

using namespace ocffm;

namespace {

// B1.  Replaces pos_hv_kt_pallas / _hv_kt_kernel (and its row-major twin
// pos_hv_blocked_pallas / _hv_blk_kernel), one_class_ffm_tpu/ops/
// sparse_ops.py:
//   out[r] = sum_{t: own_t = r} (w_scale * w_t) * pq_t * rows_t
//            + phi[r] @ dense,        pq_t = storage(<phi[r], rows_t>)
// The dense (omega Q1^T Q1) term is added inside the kernel, as the TPU
// kernel does.  The CTA body is common.cuh hv_rows (its notes say what
// bounds it and what the design does about it); each group reads its row
// of phi once, with vector loads, and writes its row of out once.
template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kHvThreads)
pos_hv_kernel(const T* __restrict__ phi, const T* __restrict__ rows,
              const int* __restrict__ runs, const T* __restrict__ w,
              const T* __restrict__ dense, T* __restrict__ out, int maxc,
              int k, int block_rows, float w_scale, int stage_slots) {
  const int64_t blk = blockIdx.x;
  hv_rows<T, G, NV, VE>(RowPhi<T>{phi, k},
                        RowStream<T>{rows + blk * maxc * k, w + blk * maxc},
                        runs, dense, out, k, block_rows, w_scale,
                        stage_slots);
}

template <typename T>
struct PosHvLaunch {
  const T* phi;
  const T* rows;
  const int* runs;
  const T *w, *dense;
  T* out;
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
      pos_hv_kernel<T, G, NV, VE><<<g.grid, kHvThreads, g.smem, st>>>(
          phi, rows, runs, w, dense, out, maxc, k, block_rows, w_scale,
          g.stage_slots);
      return (int)cudaGetLastError();
    }
  }
};

// ---------------------------------------------------------------------------
// B2, the blocked gradient scatter.  Replaces pos_scatter_kt_pallas /
// _scatter_kt_kernel:
//   out[r] = sum_{t: own_t = r} c_t * rows_t                       (slot order)
// kDiag (the Jacobi w_blk payload, from the same read of each slot's row):
//   outq[r] = storage(sum_{t: own_t = r} storage(storage(rows_t^2) * wq_t)),
//   wq_t = storage(w_t * storage(wq_scale))
//
// What bounds it on the H100: the stream (124 MB on the u side, 117 MB on
// the v side at the headline shapes) is larger than the 50 MB L2, so the
// floor is one pass over it at 3.35 TB/s.  A warp per row that searches
// its run and then adds one slot's row per dependent round trip to memory
// reaches about a quarter of that on the H100.  Here a CTA of two warps
// owns kRows consecutive rows of one block (8 at k = 32 f32: a slice of
// it, so that the v side's 79 blocks still give thousands of CTAs); their
// runs are one contiguous span of the block's slots, read from the static
// run pointer `runs` (no search).  One thread streams the span into a ring
// of kStages shared-memory stages with bulk asynchronous copies
// (cp.async.bulk, completed on an mbarrier per stage: the copy engine
// moves the bytes, no thread waits on a load), and a group of G lanes per
// row adds its slots from shared memory in slot order while the next stage
// is in flight.  Small CTAs with two stages of ~8 KB measured best on the
// H100 (u and v streams at k = 32 f32): a CTA of 32 rows walked the v
// side's spans of ~1,400 slots stage after stage with only one or two
// groups busy in each, and more or larger stages cost CTAs per SM.  A bulk
// copy needs 16-byte-aligned addresses and sizes: the span is widened to
// multiples of 8 slots (MAXC is one) and the path needs k * sizeof(T) % 16
// == 0 (VE > 1).  Any other k takes the plain-load path of the same kernel
// (VE = 1): each group reads its run from device memory in batches of D
// slots, with the same adds in the same order, so both paths give the
// same bits.
// ---------------------------------------------------------------------------

constexpr int kScatterThreads = 64;  // threads per CTA

// Adds the slots [lo, hi) to one row's sums, slot t's row at rows_p +
// (t - base) * k and its coefficient (weight) at c_p[t - base] (w_p[...]):
// device memory on the plain-load path, a shared-memory stage otherwise.
// Batches of D slots: their loads first, then the adds in slot order.
// kRoundQ: each Jacobi term rounded to storage before its add (B2).
template <typename T, int G, int NV, int VE, bool kDiag, bool kRoundQ>
__device__ __forceinline__ void scatter_slots(
    const T* rows_p, const T* c_p, const T* w_p, int base, int lo, int hi,
    int k, int lane, float wq, float (&acc)[NV][VE], float (&accq)[NV][VE]) {
  constexpr int D = batch_depth<T, NV, VE>();
  for (int t0 = lo; t0 < hi; t0 += D) {
    RawVec<T, VE> raw[D][NV];
    float ct[D], wt[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (t0 + j < hi) {
        const int64_t o = t0 + j - base;
        ct[j] = to_f(c_p[o]);
        if constexpr (kDiag) wt[j] = rnd<T>(__fmul_rn(to_f(w_p[o]), wq));
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * G + lane) * VE;
          if (c0 < k) raw[j][v] = load_raw<T, VE>(rows_p + o * k + c0);
        }
      }
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (t0 + j < hi) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if ((v * G + lane) * VE >= k) continue;
          float r[VE];
          unpack(raw[j][v], r);
#pragma unroll
          for (int i = 0; i < VE; ++i) {
            acc[v][i] = __fadd_rn(acc[v][i], __fmul_rn(ct[j], r[i]));
            if constexpr (kDiag) {
              const float q = __fmul_rn(rnd<T>(__fmul_rn(r[i], r[i])), wt[j]);
              accq[v][i] = __fadd_rn(accq[v][i], kRoundQ ? rnd<T>(q) : q);
            }
          }
        }
      }
  }
}

// B5's row stage, replacing the stage 1 of grad_cross_tbl_pallas /
// _grad_cross_tbl_kernel and grad_cross_tbl_kt_pallas (one_class_ffm_tpu/
// ops/sparse_ops.py), is B2's function plus one dense row per row:
//   payload[r] = storage(dense[r] + storage(sum_{t: own_t = r} c_t rows_t))
// kDiag (the Jacobi w_blk payload, which has no dense term):
//   payload_q[r] = storage(sum_{t: own_t = r} wq_t * storage(rows_t^2)),
// the products summed at f32 unrounded, as the TPU kernel's one-hot matmul
// sums them (B2 rounds each to storage first), for stage 2 to scatter
// through the field's X^2.  It runs on B2's body below, so it reads the
// stream once through the same stages; the row's dense row is loaded
// before the stage loop (16-byte vectors on the staged plan, a value per
// lane on the plain-load plan) and added after it: on the H100, on
// hv_pack_bench's stream, that ran the row stage ~5% and its Jacobi
// variant ~8% (f32) faster than loading it after the loop.  The warp per
// row it replaces found each run by two binary searches over the owners
// and then read the run's slots one dependent load at a time, in CTAs that
// mostly waited on latency (4.4 slots per row on the u side, 44 on the v
// side).
//
// The CTA body of both: one CTA per (block, slice of kRows rows); dynamic
// shared memory: kStages stages of `stage_slots` slots, each the slots'
// rows, then their coefficients, then (kDiag) their weights.  kDense: B5's
// row stage.
template <typename T, int G, int NV, int VE, bool kDiag, bool kDense>
__device__ __forceinline__ void scatter_rows(
    const T* __restrict__ c, const T* __restrict__ rows,
    const int* __restrict__ runs, const T* __restrict__ w, float wq_scale,
    const T* __restrict__ dense, T* __restrict__ out, T* __restrict__ outq,
    int maxc, int k, int block_rows, int stage_slots) {
  constexpr int kRows = kScatterThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t blk = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int r = r0 + (int)threadIdx.x / G;
  const bool live = r < block_rows;
  const int64_t row = blk * block_rows + r;
  const int* runs_b = runs + blk * (block_rows + 1);
  const T* c_b = c + blk * maxc;
  const T* w_b = kDiag ? w + blk * maxc : nullptr;
  const T* rows_b = rows + blk * maxc * k;
  int rs = 0, re = 0;
  if (live) {
    rs = runs_b[r];
    re = runs_b[r + 1];
  }
  // B5: the row's dense row, in flight while the stream is read (zeroed
  // first: left unset on some paths, the f32 plans kept it in a 16-byte
  // stack frame and ran ~4% slower on the H100)
  RawVec<T, VE> dn[NV];
  if constexpr (kDense) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      dn[v] = RawVec<T, VE>{};
      if (live && c0 < k) dn[v] = load_raw<T, VE>(dense + row * k + c0);
    }
  }
  const float wq = kDiag ? rnd<T>(wq_scale) : 0.f;
  float acc[NV][VE], accq[NV][VE];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[v][i] = accq[v][i] = 0.f;

  if constexpr (VE == 1) {
    scatter_slots<T, G, NV, VE, kDiag, !kDense>(rows_b, c_b, w_b, 0, rs, re,
                                                k, lane, wq, acc, accq);
  } else {
    extern __shared__ __align__(128) unsigned char stage_smem[];
    __shared__ uint64_t full[kStages];
    // the span of the CTA's rows, widened to whole 8-slot groups
    const int s = runs_b[r0], e = runs_b[min(r0 + kRows, block_rows)];
    const int w0 = s & ~7, w1 = (e + 7) & ~7;
    const int n_st = s < e ? (w1 - w0 + stage_slots - 1) / stage_slots : 0;
    const int stage_elems = stage_slots * (k + (kDiag ? 2 : 1));
    T* sm = reinterpret_cast<T*>(stage_smem);
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
      mbar_init_fence();
    }
    __syncthreads();
    auto issue = [&](int j) {  // thread 0: stage j into its buffer
      const int ws = w0 + j * stage_slots;
      const int n = min(stage_slots, w1 - ws);  // a multiple of 8 slots
      T* buf = sm + (j % kStages) * stage_elems;
      uint64_t* bar = &full[j % kStages];
      const uint32_t row_bytes = (uint32_t)n * k * sizeof(T);
      const uint32_t col_bytes = (uint32_t)n * sizeof(T);
      mbar_expect_tx(bar, row_bytes + col_bytes * (kDiag ? 2 : 1));
      bulk_load(buf, rows_b + (int64_t)ws * k, row_bytes, bar);
      bulk_load(buf + stage_slots * k, c_b + ws, col_bytes, bar);
      if constexpr (kDiag)
        bulk_load(buf + stage_slots * (k + 1), w_b + ws, col_bytes, bar);
    };
    if (threadIdx.x == 0)
      for (int j = 0; j < min(kStages, n_st); ++j) issue(j);
    for (int j = 0; j < n_st; ++j) {
      mbar_wait(&full[j % kStages], (uint32_t)(j / kStages) & 1u);
      const int ws = w0 + j * stage_slots;
      const T* buf = sm + (j % kStages) * stage_elems;
      scatter_slots<T, G, NV, VE, kDiag, !kDense>(
          buf, buf + stage_slots * k, buf + stage_slots * (k + 1), ws,
          max(rs, ws), min(re, ws + stage_slots), k, lane, wq, acc, accq);
      __syncthreads();  // every group is done with buffer j % kStages
      if (threadIdx.x == 0 && j + kStages < n_st) issue(j + kStages);
    }
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * G + lane) * VE;
    if (c0 >= k) continue;
    if constexpr (kDense) {  // dense + storage(sum), the sum rounded first
      float d[VE];
      unpack(dn[v], d);
#pragma unroll
      for (int i = 0; i < VE; ++i)
        acc[v][i] = __fadd_rn(d[i], rnd<T>(acc[v][i]));
    }
    store_vals<T, VE>(out + row * k + c0, acc[v]);
    if constexpr (kDiag) store_vals<T, VE>(outq + row * k + c0, accq[v]);
  }
}

#define OCFFM_SCATTER_PARAMS                                                \
  const T *__restrict__ c, const T *__restrict__ rows,                      \
      const int *__restrict__ runs, const T *__restrict__ w, float wq_scale, \
      const T *__restrict__ dense, T *__restrict__ out, T *__restrict__ outq, \
      int maxc, int k, int block_rows, int stage_slots
#define OCFFM_SCATTER_ARGS \
  c, rows, runs, w, wq_scale, dense, out, outq, maxc, k, block_rows, stage_slots

// B2 (dense is unused)
template <typename T, int G, int NV, int VE, bool kDiag>
__global__ void __launch_bounds__(kScatterThreads)
pos_scatter_kernel(OCFFM_SCATTER_PARAMS) {
  scatter_rows<T, G, NV, VE, kDiag, false>(OCFFM_SCATTER_ARGS);
}

// B5's row stage
template <typename T, int G, int NV, int VE, bool kDiag>
__global__ void __launch_bounds__(kScatterThreads)
grad_cross_rows_kernel(OCFFM_SCATTER_PARAMS) {
  scatter_rows<T, G, NV, VE, kDiag, true>(OCFFM_SCATTER_ARGS);
}

template <typename T, bool kDiag, bool kDense>
struct ScatterLaunch {
  const T* c;
  const T* rows;
  const int* runs;
  const T* w;
  float wq_scale;
  const T* dense;
  T *out, *outq;
  long long n_blocks;
  int maxc, k, block_rows;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    if constexpr (kDense) {
      return launch<G, VE>(grad_cross_rows_kernel<T, G, NV, VE, kDiag>);
    } else {
      return launch<G, VE>(pos_scatter_kernel<T, G, NV, VE, kDiag>);
    }
  }
  template <int G, int VE, typename K>
  int launch(K kernel) const {
    constexpr int kRows = kScatterThreads / G;
    const dim3 grid((unsigned)n_blocks, (block_rows + kRows - 1) / kRows);
    int slots = 0;
    size_t smem = 0;
    if (VE > 1) {
      slots = stage_slots_for(k * (int)sizeof(T));
      smem = (size_t)kStages * slots * (k + (kDiag ? 2 : 1)) * sizeof(T);
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kScatterThreads, smem, st>>>(
        c, rows, runs, w, wq_scale, dense, out, outq, maxc, k, block_rows,
        slots);
    return (int)cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// B3, the residual gap after a step.  Replaces pos_gap_kt_pallas /
// _gap_kt_kernel:
//   gap_t = storage(<dP[own_t], rows_t>)  for every slot, pads +0,
// flat in slot order, the dot in _lane_dot's order.  It is B1's slot
// coefficient with phi = dP and no weight, so on the staged path it runs
// B1's stage loop (common.cuh HvSpan, without the weight column): each row's
// group loads its row of dP once, every group takes batches of a stage's
// slots whichever rows own them, and the stage's gaps leave shared memory
// in slot order with coalesced stores.  A CTA writes only the slots of its
// own span (the bulk copies' 8-slot widening reaches into its neighbours');
// the last CTA of each block writes the block's pads (+0), a block without
// rows included.
//
// What bounds it on the H100: bytes, the stream once (124 MB on the u side
// at the headline shapes) plus dP and the gaps.  The warp per slot it
// replaces on these shapes ran one dependent chain per slot (the owner and
// a 64-bit division, then the dP row and the slot's row, five shuffles, one
// store) and read dP[own] again for every slot of a run (4.4 slots per row
// on the u side, 44 on the v side).
//
// Geometry: B1's CTAs of kHvThreads threads, a group of lanes per row, with
// stages of about kGapStageBytes of the stream.  On the H100 at k = 32 f32
// (the u and v streams), 4 KB stages ran the u side fastest of CTAs of 64,
// 128 and 256 threads with 2, 4, 8 or 16 KB stages: B3 copies no weight
// column and holds no accumulator rows, and smaller stages let more CTAs
// share an SM (8 rows of 4.4 slots on average span ~35 slots, ~4.5 KB).
//
// The plain-load path (k > 32, MAXC % 8 != 0 or unaligned rows) keeps the
// warp per slot, gap_slots_kernel: lanes over k, each lane summing columns
// l, l + 32, ... in turn, then the butterfly (warp_sum), _lane_dot's order;
// the lane sum starts at -0, the identity of the sum, so that a lane whose
// every product is -0 holds -0 as _lane_dot's does.
// ---------------------------------------------------------------------------

constexpr int kGapStageBytes = 4096;

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kHvThreads)
gap_rows_kernel(const T* __restrict__ dP, const T* __restrict__ rows,
                const int* __restrict__ runs, T* __restrict__ out, int maxc,
                int k, int block_rows, int stage_slots) {
  constexpr int kRows = kHvThreads / G;
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int64_t blk = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int r = r0 + grp;
  const int* runs_b = runs + blk * (block_rows + 1);
  extern __shared__ __align__(128) unsigned char gap_smem[];
  __shared__ uint64_t full[kStages];
  HvSpan<T, kRows, false> sp(gap_smem, full,
                             RowStream<T>{rows + blk * maxc * k, nullptr}, k,
                             stage_slots);
  sp.begin(runs_b, r0, block_rows);
  float ph[NV][VE];
  RowPhi<T>{dP, k}.template load<G, NV, VE>(r < block_rows,
                                            blk * block_rows + r, lane, ph);
  sp.template keep_phi<G, NV, VE>(grp, lane, ph);
  __syncthreads();  // dP, the runs and the initialised barriers are visible
  T* out_b = out + blk * maxc;
  sp.template run<G, VE>(lane, grp, group_mask<G>(), 1.f,
                         [&](const T*, int ws, int lo, int hi) {
                           for (int t = lo + (int)threadIdx.x; t < hi;
                                t += kHvThreads)
                             out_b[t] = from_f<T>(sp.coef_s[t - ws]);
                         });
  if (blockIdx.y == gridDim.y - 1)  // the block's pads, from its last run on
    for (int t = sp.e + (int)threadIdx.x; t < maxc; t += kHvThreads)
      out_b[t] = from_f<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gap_slots_kernel(const T* __restrict__ dP, const T* __restrict__ rows,
                 const int* __restrict__ own, T* __restrict__ out,
                 int64_t n_slots, int maxc, int k, int block_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < n_slots; t += n_warps) {
    const int o = own[t];
    float dot = 0.f;  // a pad's gap
    if (o < block_rows) {  // uniform across the warp
      const int64_t row = (t / maxc) * block_rows + o;
      const T* rt = rows + t * k;
      const T* dr = dP + row * k;
      float x = -0.f;
#pragma unroll
      for (int j = 0; j < kMaxKPerLane; ++j) {
        const int c = j * 32 + lane;
        if (j * 32 < k)  // a column past k adds +0, as _lane_dot's padding
          x = __fadd_rn(x, c < k ? __fmul_rn(to_f(dr[c]), to_f(rt[c])) : 0.f);
      }
      dot = warp_sum(x);
    }
    if (lane == 0) out[t] = from_f<T>(dot);
  }
}

template <typename T>
struct GapLaunch {
  const T* dP;
  const T* rows;
  const int *own, *runs;
  T* out;
  long long n_blocks;
  int maxc, k, block_rows;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    if constexpr (VE == 1) {
      const long long n_slots = n_blocks * (long long)maxc;
      gap_slots_kernel<T><<<warp_grid(n_slots), kWarps * 32, 0, st>>>(
          dP, rows, own, out, n_slots, maxc, k, block_rows);
    } else if constexpr (G * NV * VE > 32) {
      return (int)cudaErrorInvalidValue;  // hv_staged admits k <= 32 only
    } else {
      const HvGrid g = hv_grid<T, G, VE, false>(n_blocks, k, block_rows,
                                                kGapStageBytes);
      gap_rows_kernel<T, G, NV, VE><<<g.grid, kHvThreads, g.smem, st>>>(
          dP, rows, runs, out, maxc, k, block_rows, g.stage_slots);
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int ocffm_max_k() { return kMaxKPerLane * 32; }

// runs: (n_blocks, block_rows + 1) row runs of slots
int ocffm_pos_hv_blocked(int dtype, const void* phi, const void* rows,
                         const void* runs, const void* w, const void* dense,
                         void* out, long long n_blocks, int maxc, int k,
                         int block_rows, float w_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const void* ptrs[] = {phi, rows, w, dense, out};
  const bool staged = hv_staged(k, maxc, dtype == kF32 ? 4 : 2, ptrs, 5);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, staged, PosHvLaunch<T>{
      (const T*)phi, (const T*)rows, (const int*)runs, (const T*)w,
      (const T*)dense, (T*)out, n_blocks, maxc, k, block_rows, w_scale, st}));
}

// w == nullptr: the gradient scatter alone; otherwise also the Jacobi
// payload into outq.  runs: (n_blocks, block_rows + 1) row runs of slots.
int ocffm_pos_scatter_blocked(int dtype, const void* c, const void* rows,
                              const void* runs, const void* w,
                              float wq_scale, void* out, void* outq,
                              long long n_blocks, int maxc, int k,
                              int block_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const void* ptrs[] = {c, rows, w, out, outq};
  // the bulk copies start at 8-slot boundaries of each block's MAXC slots
  const bool vec = maxc % 8 == 0 && vec_ok(k, dtype == kF32 ? 4 : 2, ptrs, 5);
  if (w == nullptr) {
    OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec,
        ScatterLaunch<T, false, false>{(const T*)c, (const T*)rows,
            (const int*)runs, nullptr, wq_scale, nullptr, (T*)out, nullptr,
            n_blocks, maxc, k, block_rows, st}));
  }
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec,
      ScatterLaunch<T, true, false>{(const T*)c, (const T*)rows,
          (const int*)runs, (const T*)w, wq_scale, nullptr, (T*)out,
          (T*)outq, n_blocks, maxc, k, block_rows, st}));
}

// B5's row stage: payload (and with w, the Jacobi payload_q) per data row,
// for the X^T stage (table_ops.cu) to scatter; runs: (n_blocks, block_rows
// + 1) row runs of slots.
int ocffm_grad_cross_tbl_rows(int dtype, const void* c, const void* w,
                              float wq_scale, const void* rows,
                              const void* runs, const void* dense,
                              void* payload, void* payload_q,
                              long long n_blocks, int maxc, int k,
                              int block_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const void* ptrs[] = {c, rows, w, dense, payload, payload_q};
  const bool vec = maxc % 8 == 0 && vec_ok(k, dtype == kF32 ? 4 : 2, ptrs, 6);
  if (w == nullptr) {
    OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec,
        ScatterLaunch<T, false, true>{(const T*)c, (const T*)rows,
            (const int*)runs, nullptr, wq_scale, (const T*)dense,
            (T*)payload, nullptr, n_blocks, maxc, k, block_rows, st}));
  }
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec,
      ScatterLaunch<T, true, true>{(const T*)c, (const T*)rows,
          (const int*)runs, (const T*)w, wq_scale, (const T*)dense,
          (T*)payload, (T*)payload_q, n_blocks, maxc, k, block_rows, st}));
}

// runs: (n_blocks, block_rows + 1) row runs of slots (the staged path);
// own: the slots' owners (the plain-load path)
int ocffm_pos_gap_blocked(int dtype, const void* dP, const void* rows,
                          const void* own, const void* runs, void* out,
                          long long n_blocks, int maxc, int k, int block_rows,
                          void* stream) {
  const void* ptrs[] = {dP, rows};
  const bool staged = hv_staged(k, maxc, dtype == kF32 ? 4 : 2, ptrs, 2);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, staged, GapLaunch<T>{
      (const T*)dP, (const T*)rows, (const int*)own, (const int*)runs,
      (T*)out, n_blocks, maxc, k, block_rows, (cudaStream_t)stream}));
}

}  // extern "C"
