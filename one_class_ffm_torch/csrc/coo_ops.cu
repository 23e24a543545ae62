// Hopper (sm_90a) kernels for the positive passes of a side without a
// blocked layout (a COO side, ops/sparse_ops.py "the plain COO positive
// passes"), and for pos_dot, the stream's gather-and-dot.  Built with the
// other sources into one shared library (ops/kernels.py), bound with
// ctypes.
//
// coo_list_kernel replaces the JAX package's XLA segment sums of a COO
// side (one_class_ffm_tpu/ops/sparse_ops.py:230 pos_scatter, :264
// pos_scatter_pair, solver/jax_solver.py:1215 the self blocks'
// segment_sum) and its COO Hv, pos_dot then pos_scatter of (1 - omega) pq
// (solver/jax_solver.py:1900-1901).  It walks the side's destination-major
// list of the positive stream (ops/layout.py coo_list: a row of the side
// per "feature", its entries in stream order, power rows cut into chunks of
// at most 128; `row` the other side's id, `pos` the stream position, `w`
// the stream's weight in list order) with one of five sources, fixed at
// compile time, each entry's term rounded to storage as the JAX ops form
// their payloads at storage dtype and summed per column at f32 in list
// order:
//   kCoef  out[s] = sum storage(c[pos] B[row])                 (pos_scatter)
//   kPair  out0 as kCoef, out1[s] = sum storage(storage(wq B[row]) B[row]),
//          wq = storage(w * scale): both from one read of each row
//                                                        (pos_scatter_pair)
//   kSq    out1's sums alone                   (the Jacobi diagonal's term)
//   kHv    out[s] = sum storage(cv B[row]),  cv = storage(storage(
//          storage(dot(phi[s], B[row])) * w) * scale): the cross Hv of a
//          COO side, pos_dot, the (1 - omega) w scaling and pos_scatter in
//          one pass; the dot in pos_dot's order (below), the (nnz,)
//          coefficients and both (nnz, k) gathers never written (pos_hv_coo)
//   kSum   out[s] = sum c[pos] (k = 1), L lanes a chunk (L = 1 or 8, the
//          caller's choice from the list's shape: ops/layout.py
//          seg_sum_lanes), lane l adding the chunk's entries l, l + L, ...
//          in turn, then an xor butterfly over the L lanes, the order of
//          _lane_sum on L lanes                              (pos_seg_sum)
// A group of G lanes sums each chunk (list_pass, gather_rows below); the
// finish of a power row's chunks in chunk order is the X^T stage's
// (common.cuh chunk_finish): no float atomics, the same bits on every run
// and the plain versions' bits.
//
// What bounds it on the H100.  The work is bytes: the list (row, pos, w:
// 12 B an entry), the coefficients (random 4-byte reads at pos on the v
// side), phi and the output (128 B a row at k = 32 f32: on the u side 25.6
// MB each, the largest single arrays) and the gathered rows of B, which
// fit the 50 MB L2 (2.6 MB / 25.6 MB at f32) and are counted once.  On the
// u side a chunk is one user's ~4.4 entries, so time goes to dependent
// round trips (chunk bounds, then ids, then rows), not to bandwidth.  What
// the design does about it:
//   - a group of G lanes (G = k / VE: 8 at k = 32 f32, 4 at bf16) takes a
//     chunk, so a warp sums 4 (8) users' chunks at once; a batch of D rows
//     (16 B a lane) is loaded before the first of its ordered adds, and the
//     next batch's ids and scalars while they are in flight: the X^T
//     stage's loop, whose broadcast id loads ran faster on the H100 than
//     ids loaded once per group and shuffled out, whether a group's rounds
//     stayed in one chunk or ran across several short ones (those took
//     1.2-1.8x this loop's time for pos_scatter at the FFM's 200k x 20k,
//     k = 32 f32);
//   - the static weights are read in list order (coo_list's w, permuted
//     once when the list is built), not at the stream position;
//   - kPair forms both payloads from one read of each row: one launch;
//   - kHv loads phi of the chunk's row beside its first ids and keeps it in
//     registers; the dots of a batch go through one butterfly (common.cuh
//     lane_tree), TD at a time;
//   - the width-1 sums take a lane a chunk where the chunks are short (a
//     user's, or a uniform catalog's item), 8 where most entries sit in
//     long chunks (a skewed catalog's power items), where one lane's walk
//     would hold its warp;
//   - kPair and kHv, which hold two payloads or phi and the dots beside a
//     batch's rows, run 2 CTAs per SM (at most 128 registers), the others
//     3 (85), as the X^T stage does;
//   - plain loads: the list's arrays read through the non-coherent path
//     (__ldg) ran pos_scatter 5-12% slower on the H100.
//
// pos_dot_kernel replaces the XLA gather-and-sum pos_dot
// (one_class_ffm_tpu/ops/sparse_ops.py:215): out[t] = storage(dot(A[u_t],
// B[v_t])), ids clamped into range as XLA clamps its gathers, products at
// storage, the 32 lane sums of _lane_dot at f32 (lane l adds columns l,
// l + 32, ... in turn, then an xor butterfly), rounded once.  A group of G
// lanes takes D consecutive entries: their ids in one coalesced load, all
// 2 D rows issued (16 B a lane), the dots through one butterfly, one value
// stored per entry; over a grid of the CTAs the SMs hold at once, each
// group loads its next D entries' ids while this D's rows are in flight.
// Bound: bytes, the ids and output (12 B an entry) and the rows the ids
// name (B's mostly from L2); the XLA form wrote, read and summed two (nnz,
// k) gathers.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// fused multiply-add), in the order the plain versions in ops/sparse_ops.py
// follow.

#include "common.cuh"

using namespace ocffm;

namespace {

// the sources (an int template argument: cuobjdump then names it)
enum CooSrc { kCoef, kPair, kSq, kHv, kSum };

// The pass over the list: a group of G lanes per chunk (grid-stride), then
// the rows without entries; body.sum(ch, s, e, lane, gmask, acc) adds chunk
// ch's entries [s, e) to acc (+0 on entry), common.cuh chunk_finish ends
// the chunk, body.store(f, sums) writes row f.
template <int G, int NV, int VE, int NOUT, class Body>
__device__ __forceinline__ void list_pass(const ChunkPlan& p, int k,
                                          const Body& body) {
  constexpr int kGroups = kWarps * 32 / G;
  const int lane = threadIdx.x % G;
  const unsigned gmask = group_mask<G>();
  const int n_groups = gridDim.x * kGroups;
  for (int it = blockIdx.x * kGroups + threadIdx.x / G;
       it < p.n_chunks + p.n_combine; it += n_groups) {
    float acc[NOUT][NV][VE];
    zero_sums(acc);
    if (it >= p.n_chunks) {  // a feature without entries: zero
      const int f = p.combine[it - p.n_chunks];
      if (p.feat_ptr[f + 1] == p.feat_ptr[f]) body.store(f, acc);
      continue;
    }
    const int s = p.chunk_ptr[it], e = p.chunk_ptr[it + 1];
    const int dst = p.chunk_dst[it];
    body.sum(it, s, e, lane, gmask, acc);
    chunk_finish<G, NV, VE, NOUT>(p, it, dst, acc, k, lane, gmask, body);
  }
}

// Adds a chunk's entries [s, e) to acc in order, through `src`: D entries
// a batch, their rows of src.rows (k wide) all loaded, 16 bytes a lane,
// before the first of their ordered adds, and the next batch's entries read
// while those rows are in flight.  Src provides
//   Entry                 an entry's row id (`row`) and scalars;
//   entry(t)              reads entry t;
//   batch(raw, x, n)      the batch's work before its adds (n valid);
//   add(x, f, acc, v)     x's terms of vector v (f: its VE values at f32).
template <typename T, int G, int NV, int VE, int D, int NOUT, class Src>
__device__ __forceinline__ void gather_rows(const Src& src, int s, int e,
                                            int k, int lane, unsigned gmask,
                                            float (&acc)[NOUT][NV][VE]) {
  using E = typename Src::Entry;
  E cur[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (s + j < e) cur[j] = src.entry(s + j);
  for (int b0 = s; b0 < e; b0 += D) {
    RawVec<T, VE> raw[D][NV];
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (b0 + j < e) {
        const T* pr = src.rows + (int64_t)cur[j].row * k;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * G + lane) * VE;
          if (c0 < k) raw[j][v] = load_raw<T, VE>(pr + c0);
        }
      }
    E nxt[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (b0 + D + j < e) nxt[j] = src.entry(b0 + D + j);
    src.batch(raw, cur, e - b0, lane, gmask);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (b0 + j < e) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if ((v * G + lane) * VE >= k) continue;
          float f[VE];
          unpack(raw[j][v], f);
          src.add(cur[j], f, acc, v);
        }
      }
#pragma unroll
    for (int j = 0; j < D; ++j) cur[j] = nxt[j];
  }
}

template <typename T>
struct CooArgs {
  const int* row;        // (nnz,) the other side's id per entry
  const int* pos;        // (nnz,) the stream position per entry
  const T* w;            // (nnz,) the stream's weight per entry, list order
  const T* c;            // (stream,) the coefficient per stream entry
  const T* B;            // (n_rows, k) the gathered table
  const T* phi;          // (d, k) the side's rows of phi (kHv)
  float scale;           // storage(wq_scale) or storage(w_scale)
  const int* chunk_row;  // (n_chunks,) each chunk's row (kHv)
  ChunkPlan plan;        // partial: NOUT * k floats per partial row
  T *out0, *out1;        // (d, k) storage; out1 the kPair / kSq sums
  int k;
};

template <int S>
__host__ __device__ constexpr int coo_nout() {
  return S == kPair ? 2 : 1;
}

// entries per batch: their row loads are all issued before the first of
// their ordered adds (the X^T stage's depth: 4 at k = 32, 2 where a lane
// holds 8 registers of a row)
template <typename T, int NV, int VE>
__host__ __device__ constexpr int coo_depth() {
  return batch_depth<T, NV, VE>() > 4 ? batch_depth<T, NV, VE>() / 2 : 2;
}

// gather_rows' source for the four row-gathering sources: an entry's row
// id and its scalar `val` (kCoef, kPair: c[pos]; kHv: w, then cv once the
// batch's dots are in) and `w` (kPair, kSq: wq = storage(w * scale))
template <typename T, int G, int NV, int VE, int S>
struct CooEntries {
  const T* rows;  // B
  const int *row, *pos;
  const T *w, *c;
  float scale;
  int k;
  RawVec<T, VE> praw[NV];  // kHv: phi of the chunk's row
  struct Entry {
    int row;
    float val, w;
  };
  __device__ __forceinline__ Entry entry(int t) const {
    Entry x;
    x.row = row[t];
    if constexpr (S == kCoef || S == kPair) x.val = to_f(c[pos[t]]);
    if constexpr (S == kHv) x.val = to_f(w[t]);
    if constexpr (S == kPair || S == kSq)
      x.w = rnd<T>(__fmul_rn(to_f(w[t]), scale));
    return x;
  }
  // kHv: the batch's dots with phi (lane sums of columns l, l + 32, ... in
  // turn, products at storage, past k +0; then one butterfly per TD dots),
  // and each entry's cv
  template <int D>
  __device__ __forceinline__ void batch(const RawVec<T, VE> (&raw)[D][NV],
                                        Entry (&x)[D], int n, int lane,
                                        unsigned gmask) const {
    if constexpr (S == kHv) {
      constexpr int TD = D < 16 / VE ? D : (16 / VE > 0 ? 16 / VE : 1);
      float ph[NV][VE];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if ((v * G + lane) * VE < k) {
          unpack(praw[v], ph[v]);
        } else {
#pragma unroll
          for (int i = 0; i < VE; ++i) ph[v][i] = 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < D; h += TD) {
        float y[TD][VE];
#pragma unroll
        for (int jj = 0; jj < TD; ++jj) {
          const int j = h + jj;
          float r[NV][VE];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if (j < n && (v * G + lane) * VE < k) {
              unpack(raw[j][v], r[v]);
            } else {
#pragma unroll
              for (int i = 0; i < VE; ++i) r[v][i] = 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < VE; ++i) {
            y[jj][i] = rnd<T>(__fmul_rn(ph[0][i], r[0][i]));
#pragma unroll
            for (int v = 1; v < NV; ++v)
              if (v * G * VE < k)
                y[jj][i] =
                    __fadd_rn(y[jj][i], rnd<T>(__fmul_rn(ph[v][i], r[v][i])));
          }
        }
        lane_tree<G, VE, TD>(y, gmask);
#pragma unroll
        for (int jj = 0; jj < TD; ++jj)
          if (h + jj < n) {
            const float pq = rnd<T>(__fmul_rn(rnd<T>(y[jj][0]), x[h + jj].val));
            x[h + jj].val = rnd<T>(__fmul_rn(pq, scale));
          }
      }
    }
  }
  template <int NOUT>
  __device__ __forceinline__ void add(const Entry& x, const float (&f)[VE],
                                      float (&acc)[NOUT][NV][VE],
                                      int v) const {
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      if constexpr (S != kSq)
        acc[0][v][i] = __fadd_rn(acc[0][v][i], rnd<T>(__fmul_rn(x.val, f[i])));
      if constexpr (S == kPair || S == kSq)
        acc[NOUT - 1][v][i] = __fadd_rn(
            acc[NOUT - 1][v][i],
            rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(x.w, f[i])), f[i])));
    }
  }
};

// list_pass's body of coo_list_kernel: a chunk's entries (the width-1
// sums, or a row-gathering source through gather_rows), a row's NOUT sums
// stored at storage dtype (kSq's in out1)
template <typename T, int G, int NV, int VE, int S>
struct CooBody {
  static constexpr int NOUT = coo_nout<S>();
  const CooArgs<T>& a;
  __device__ __forceinline__ void sum(int ch, int s, int e, int lane,
                                      unsigned gmask,
                                      float (&acc)[NOUT][NV][VE]) const {
    const int k = a.k;
    if constexpr (S == kSum) {
      // lane l adds the chunk's entries l, l + G, ... in turn, D of them
      // loaded (coalesced across the group) before their adds; then the
      // butterfly (4, 2, 1 at G = 8)
      constexpr int D = G == 1 ? 8 : 4;
      for (int b0 = s; b0 < e; b0 += D * G) {
        float x[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const int t = b0 + lane + G * i;
          x[i] = t < e ? to_f(a.c[a.pos[t]]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < D; ++i)
          if (b0 + lane + G * i < e)
            acc[0][0][0] = __fadd_rn(acc[0][0][0], x[i]);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        acc[0][0][0] = __fadd_rn(
            acc[0][0][0], __shfl_xor_sync(gmask, acc[0][0][0], off, G));
    } else {
      CooEntries<T, G, NV, VE, S> src{a.B, a.row, a.pos, a.w,
                                      a.c, a.scale, k, {}};
      if constexpr (S == kHv) {
        const T* pp = a.phi + (int64_t)a.chunk_row[ch] * k;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * G + lane) * VE;
          if (c0 < k) src.praw[v] = load_raw<T, VE>(pp + c0);
        }
      }
      gather_rows<T, G, NV, VE, coo_depth<T, NV, VE>()>(src, s, e, k, lane,
                                                        gmask, acc);
    }
  }
  __device__ __forceinline__ void store(
      int f, const float (&sum)[NOUT][NV][VE]) const {
    const int lane = threadIdx.x % G, k = a.k;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      T* out = (S == kSq || o == 1) ? a.out1 : a.out0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c0 = (v * G + lane) * VE;
        if (c0 < k) store_vals<T, VE>(out + (int64_t)f * k + c0, sum[o][v]);
      }
    }
  }
};

template <typename T, int G, int NV, int VE, int S>
__global__ void __launch_bounds__(kWarps * 32,
                                  S == kPair || S == kHv ? 2 : 3)
coo_list_kernel(const __grid_constant__ CooArgs<T> a) {
  list_pass<G, NV, VE, coo_nout<S>()>(a.plan, a.k,
                                      CooBody<T, G, NV, VE, S>{a});
}

template <typename T>
struct CooLaunch {
  CooArgs<T> a;
  CooSrc src;
  cudaStream_t st;
  template <int G, int NV, int VE, int S>
  int go() const {
    coo_list_kernel<T, G, NV, VE, S>
        <<<group_grid((long long)a.plan.n_chunks + a.plan.n_combine, G),
           kWarps * 32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  // the width-1 sums' plans, <1, 1, 1> and <8, 1, 1>, which by_width never
  // picks
  int run_sum(int lanes) const {
    if (lanes == 1) return go<1, 1, 1, kSum>();
    if (lanes == 8) return go<8, 1, 1, kSum>();
    return (int)cudaErrorInvalidValue;
  }
  // the four row-gathering sources (kHv only where its dot takes
  // _lane_dot's order: G * VE <= 32 on the vector path)
  template <int G, int NV, int VE>
  int run() const {
    switch (src) {
      case kCoef:
        return go<G, NV, VE, kCoef>();
      case kPair:
        return go<G, NV, VE, kPair>();
      case kSq:
        return go<G, NV, VE, kSq>();
      case kHv:
        if constexpr (VE > 1 && G * NV * VE > 32) {
          return (int)cudaErrorInvalidValue;
        } else {
          return go<G, NV, VE, kHv>();
        }
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
};

template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kWarps * 32)
pos_dot_kernel(const T* __restrict__ A, const int* __restrict__ u, int na,
               const T* __restrict__ B, const int* __restrict__ v, int nb,
               T* __restrict__ out, long long n, int k) {
  constexpr int kGroups = kWarps * 32 / G;
  constexpr int regs = NV * (VE * (int)sizeof(T) >= 4
                                 ? VE * (int)sizeof(T) / 4 : 1);
  constexpr int D = regs >= 8 ? 2 : 4;  // entries per group: 2 D rows
  constexpr int IPL = (D + G - 1) / G;
  constexpr int TD = D < 16 / VE ? D : (16 / VE > 0 ? 16 / VE : 1);
  const int lane = threadIdx.x % G;
  const unsigned gmask = group_mask<G>();
  const long long step = (long long)gridDim.x * kGroups * D;
  // the ids of entries [t, t + D), entry o = lane + G * i in the lane
  auto load_ids = [&](long long t, int (&iu)[IPL], int (&iv)[IPL]) {
#pragma unroll
    for (int i = 0; i < IPL; ++i) {
      const int o = lane + G * i;
      iu[i] = iv[i] = 0;
      if (o < D && t + o < n) {
        iu[i] = min(max(u[t + o], 0), na - 1);
        iv[i] = min(max(v[t + o], 0), nb - 1);
      }
    }
  };
  long long t0 = ((long long)blockIdx.x * kGroups + threadIdx.x / G) * D;
  int iu[IPL], iv[IPL];
  load_ids(t0, iu, iv);
  for (; t0 < n; t0 += step) {
    RawVec<T, VE> ra[D][NV], rb[D][NV];
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (t0 + j < n) {
        const T* pa =
            A + (int64_t)__shfl_sync(gmask, iu[j / G], j % G, G) * k;
        const T* pb =
            B + (int64_t)__shfl_sync(gmask, iv[j / G], j % G, G) * k;
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          const int c0 = (w * G + lane) * VE;
          if (c0 < k) {
            ra[j][w] = load_raw<T, VE>(pa + c0);
            rb[j][w] = load_raw<T, VE>(pb + c0);
          }
        }
      }
    load_ids(t0 + step, iu, iv);  // the next D, while these rows load
    float dots[D];
#pragma unroll
    for (int h = 0; h < D; h += TD) {
      float x[TD][VE];
#pragma unroll
      for (int jj = 0; jj < TD; ++jj) {
        const int j = h + jj;
        float fa[NV][VE], fb[NV][VE];
#pragma unroll
        for (int w = 0; w < NV; ++w) {
          if (t0 + j < n && (w * G + lane) * VE < k) {
            unpack(ra[j][w], fa[w]);
            unpack(rb[j][w], fb[w]);
          } else {
#pragma unroll
            for (int i = 0; i < VE; ++i) fa[w][i] = fb[w][i] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < VE; ++i) {
          x[jj][i] = rnd<T>(__fmul_rn(fa[0][i], fb[0][i]));
#pragma unroll
          for (int w = 1; w < NV; ++w)
            if (w * G * VE < k)
              x[jj][i] = __fadd_rn(x[jj][i],
                                   rnd<T>(__fmul_rn(fa[w][i], fb[w][i])));
        }
      }
      lane_tree<G, VE, TD>(x, gmask);
#pragma unroll
      for (int jj = 0; jj < TD; ++jj) dots[h + jj] = x[jj][0];
    }
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (lane == j % G && t0 + j < n) out[t0 + j] = from_f<T>(dots[j]);
  }
}

template <typename T>
struct PosDotLaunch {
  const T* A;
  const int* u;
  int na;
  const T* B;
  const int* v;
  int nb;
  T* out;
  long long n;
  int k;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    if constexpr (VE > 1 && G * NV * VE > 32) {
      return (int)cudaErrorInvalidValue;  // _lane_dot's order: k <= 32 here
    } else {
      constexpr int regs = NV * (VE * (int)sizeof(T) >= 4
                                     ? VE * (int)sizeof(T) / 4 : 1);
      const long long tiles = (n + (regs >= 8 ? 2 : 4) - 1) /
                              (regs >= 8 ? 2 : 4);
      static const long long resident =
          resident_ctas(pos_dot_kernel<T, G, NV, VE>);
      const unsigned grid = group_grid(tiles, G);
      pos_dot_kernel<T, G, NV, VE>
          <<<grid < resident ? grid : (unsigned)resident, kWarps * 32, 0,
             st>>>(A, u, na, B, v, nb, out, n, k);
      return (int)cudaGetLastError();
    }
  }
};

}  // namespace

extern "C" {

// One pass over a COO side's list (source 0 kCoef, 1 kPair, 2 kSq, 3 kHv,
// 4 kSum; see the top of this file).  row, pos, w: the list's entries;
// chunk_ptr, chunk_dst, chunk_row (each chunk's row), feat_ptr, combine,
// slot_feat: its chunks and plan (ops/layout.py coo_list, xt_plan); c the
// coefficients per stream entry; B (n_rows, k); phi (d, k); out0 / out1
// (d, k) at storage dtype (kSum: k = 1, `sum_lanes` 1 or 8 lanes a chunk;
// kSq writes out1 alone); `partial` holds NOUT * k floats for each chunk
// whose chunk_dst is >= 0; `ticket` one int per row, zero before and after
// each launch.
int ocffm_coo_list(int dtype, int source, const void* row, const void* pos,
                   const void* w, const void* c, const void* B,
                   const void* phi, float scale, const void* chunk_ptr,
                   const void* chunk_dst, const void* chunk_row, int n_chunks,
                   const void* feat_ptr, const void* combine, int n_combine,
                   const void* slot_feat, void* ticket, void* partial,
                   void* out0, void* out1, int k, int sum_lanes,
                   void* stream) {
  if (n_chunks + n_combine == 0) return 0;
  const bool coef = source == kCoef || source == kPair || source == kSum;
  const bool wts = source == kPair || source == kSq || source == kHv;
  if (source < kCoef || source > kSum || (coef && (c == nullptr ||
                                                   pos == nullptr)) ||
      (wts && w == nullptr) || (source != kSum && B == nullptr) ||
      (source == kHv && (phi == nullptr || chunk_row == nullptr)) ||
      (source == kSum ? k != 1 : row == nullptr) ||
      (source == kSq ? out1 == nullptr : out0 == nullptr) ||
      (source == kPair && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int eb = dtype == kF32 ? 4 : 2;
  const void* ptrs[] = {B, phi, out0, out1, partial};
  const bool vec = vec_ok(k, eb, ptrs, 5) && (source != kHv || k <= 32);
  cudaStream_t st = (cudaStream_t)stream;
  OCFFM_BY_DTYPE(dtype, {
    const CooLaunch<T> l{
        {(const int*)row, (const int*)pos, (const T*)w, (const T*)c,
         (const T*)B, (const T*)phi, scale, (const int*)chunk_row,
         {(const int*)chunk_ptr, (const int*)chunk_dst, n_chunks,
          (const int*)feat_ptr, (const int*)combine, n_combine,
          (const int*)slot_feat, (int*)ticket, (float*)partial},
         (T*)out0, (T*)out1, k},
        (CooSrc)source, st};
    return source == kSum ? l.run_sum(sum_lanes) : by_width<T>(k, vec, l);
  });
}

// out (n,) storage: out[t] = dot(A[u[t]], B[v[t]]), ids clamped into
// [0, na) / [0, nb); A (na, k), B (nb, k)
int ocffm_pos_dot(int dtype, const void* A, const void* u, int na,
                  const void* B, const void* v, int nb, void* out,
                  long long n, int k, void* stream) {
  if (n == 0) return 0;
  if (na < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {A, B};
  const bool vec = k <= 32 && vec_ok(k, dtype == kF32 ? 4 : 2, ptrs, 2);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, vec, PosDotLaunch<T>{
      (const T*)A, (const int*)u, na, (const T*)B, (const int*)v, nb,
      (T*)out, n, k, (cudaStream_t)stream}));
}

}  // extern "C"
