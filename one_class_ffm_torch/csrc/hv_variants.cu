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
// with B1's roundings and order (slots in slot order, then the dense term),
// so both give B1's bits.  Like B1 they read the stream once and do O(k)
// flops per element read: they are bound by device-memory bandwidth.
//
// What the TPU layouts were for, and what is left of them here:
// - The packed layout (n_blocks, MAXC/4, 128) put four k = 32 entries in one
//   128-lane row so that the MXU's M dimension grew from k to MAXC/4; entry
//   e = j * MAXC/4 + c sits at [c, 32j:32j+32], and its owner and weight are
//   copied to all 32 lanes of the group.  A warp reads an entry's 32 values
//   as one coalesced 128-byte row (f32) wherever it sits, so B9 costs the
//   index arithmetic of Packed4 and nothing else; it reads one lane of each
//   owner/weight group (1/32 of those arrays).  B9 is still the warp per
//   row of common.cuh hv_out_row.
// - G blocks per grid step amortised the TPU's per-step overhead.  On
//   Hopper a CTA of B1 (8 rows of k = 32) holds a span of ~35 slots on the
//   u side, one or two stages, and waits on its first bulk copy's latency
//   more than on bandwidth.  B10 runs B1's CTA body over the same rows of G
//   blocks with one ring of stages across them, so that block g + 1's first
//   stages are in flight while block g's last is computed.

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
// CTA (x, y) runs the kRows rows [y * kRows, (y + 1) * kRows) of each of the
// blocks x * G, ..., x * G + G - 1 in turn, on B1's CTA body (common.cuh
// HvSpan, hv_stage_dots, hv_stage_adds, hv_finish; the width plans of
// by_width).  The new part is the ring: the CTA's G spans, each widened to
// whole 8-slot groups, are one sequence of stages through HvSpan's kStages
// buffers.  Stage J of the sequence uses buffer J % kStages and the phase
// J / kStages of its barrier, so the barriers are initialised once and
// their parity runs on across blocks; thread 0 keeps kStages stages in
// flight, issuing the next stage of the sequence, whichever block it
// belongs to, as each stage frees its buffer.  Blocks whose slice holds no
// slots add no stages.  The CTA's rows' runs of all G blocks are copied to
// shared memory once; each block's phi rows are loaded into registers
// while the previous block's stages run, and go to shared memory into two
// buffers in turn, so that writing block g + 1's never waits for block g's
// last reads.  The plain-load plan is B1's: each group reads its rows'
// runs from device memory, block after block.
//
// Geometry: B1's CTAs (kHvThreads threads) and 8 KB stages.  On the H100 at
// k = 32, of 2, 4 and 8 KB stages with one or two phi buffers, 8 KB with
// two ran fastest on MF's v stream and hv_pack_bench's f32 one and within
// 1% of the fastest on MF's u stream (bf16: one buffer, 3% faster), and G
// = 2 no faster than G = 1: a CTA's next block's first stage in flight
// under its last one does not shorten the CTA.
template <typename T, int G, int NV, int VE>
__global__ void __launch_bounds__(kHvThreads)
pos_hv_ring_kernel(const T* __restrict__ phi, const T* __restrict__ rows,
                   const int* __restrict__ runs, const T* __restrict__ w,
                   const T* __restrict__ dense, T* __restrict__ out, int maxc,
                   int k, int block_rows, int groups, float w_scale,
                   int stage_slots) {
  constexpr int kRows = kHvThreads / G;
  constexpr bool kStaged = VE > 1;
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const unsigned gmask = group_mask<G>();
  const int r0 = blockIdx.y * kRows;
  const int r = r0 + grp;
  const bool live = r < block_rows;
  const int64_t b0 = (int64_t)blockIdx.x * groups;

  extern __shared__ __align__(128) unsigned char hv_smem[];
  __shared__ uint64_t full[kStages];
  HvSpan<T, kRows, true> sp(hv_smem, full, rows, w, k, stage_slots);
  auto n_stages = [&](int s, int e) {  // none on the plain-load plan
    return kStaged && s < e
               ? (((e + 7) & ~7) - (s & ~7) + stage_slots - 1) / stage_slots
               : 0;
  };
  // block g's span [cs, ce) and its cn stages, and the row's run [rs, re):
  // block 0's from device memory, as B1 reads them
  const int* runs0 = runs + b0 * (block_rows + 1);
  int cs = runs0[r0], ce = runs0[min(r0 + kRows, block_rows)];
  int rs = 0, re = 0;
  if (live) {
    rs = runs0[r];
    re = runs0[r + 1];
  }
  // thread 0's cursor: the next stage to issue, iJ of the sequence, stage
  // ij of the in stages of block ig's span [is, ie)
  int ig = 0, ij = 0, iJ = 0, is = cs, ie = ce, in = 0;
  auto issue_next = [&]() {
    while (ig < groups && ij == in) {
      if (++ig < groups) {  // the next block's span, from device memory
        const int* rb = runs + (b0 + ig) * (block_rows + 1);
        is = rb[r0];
        ie = rb[min(r0 + kRows, block_rows)];
        in = n_stages(is, ie);
        ij = 0;
      }
    }
    if (ig == groups) return;
    const int64_t b = b0 + ig;
    sp.issue_at(iJ, rows + b * maxc * k, w + b * maxc,
                (is & ~7) + ij * stage_slots, (ie + 7) & ~7);
    ++ij;
    ++iJ;
  };
  if (kStaged && threadIdx.x == 0) {  // the first stages, before all else
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
    mbar_init_fence();
    in = n_stages(is, ie);
    for (int i = 0; i < kStages; ++i) issue_next();
  }
  // the CTA's runs of each block g at runs_all + g * (kRows + 1) (HvSpan's
  // runs_s, extended), then, 16-byte aligned, the second phi buffer at
  // phi_s + phi_off (an offset, not a pointer of its own, so that every
  // access stays a shared-memory one)
  int* const runs_all = sp.runs_s;
  float* const phi0 = sp.phi_s;
  const int phi_off =
      kRows * sp.kp + stage_slots + ((groups * (kRows + 1) + 3) & ~3);
  for (int i = threadIdx.x; i < groups * (kRows + 1); i += kHvThreads) {
    const int g = i / (kRows + 1);
    runs_all[i] = runs[(b0 + g) * (block_rows + 1) +
                       min(r0 + i - g * (kRows + 1), block_rows)];
  }

  // each block's phi row: in registers while the previous block runs
  RawVec<T, VE> pn[NV];
  auto fetch = [&](int g) {
    const int64_t row = (b0 + g) * block_rows + r;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (live && c0 < k) pn[v] = load_raw<T, VE>(phi + row * k + c0);
    }
  };
  fetch(0);
  int cn = n_stages(cs, ce);
  int J0 = 0;  // the block's first stage in the sequence
  for (int g = 0; g < groups; ++g) {
    const int64_t b = b0 + g;
    float ph[NV][VE];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * G + lane) * VE;
      if (live && c0 < k) {
        unpack(pn[v], ph[v]);
      } else {
#pragma unroll
        for (int i = 0; i < VE; ++i) ph[v][i] = 0.f;
      }
    }
    sp.phi_s = phi0 + (g & 1) * phi_off;
    sp.runs_s = runs_all + g * (kRows + 1);
    sp.s = cs;
    sp.e = ce;
    sp.w0 = cs & ~7;
    sp.n_st = cn;
    sp.template keep_phi<G, NV, VE>(grp, lane, ph);
    if (g + 1 < groups) fetch(g + 1);
    __syncthreads();  // phi, the runs and the initialised barriers are visible
    float acc[NV][VE];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[v][i] = 0.f;
    if constexpr (!kStaged) {
      hv_slots<T, G, NV, VE>(rows + b * maxc * k, w + b * maxc, rs, re, k,
                             lane, gmask, w_scale, ph, acc);
    } else {
      sp.template run_from<G, VE>(
          J0, lane, grp, gmask, w_scale,
          [&](const T* buf, int ws, int, int) {
            if (lane * VE < k)
              hv_stage_adds<T, VE>(buf, sp.coef_s, ws, max(rs, ws),
                                   min(re, ws + stage_slots), k, lane * VE,
                                   acc[0]);
          },
          [&](int) { issue_next(); });
      J0 += cn;
    }
    if (live)
      hv_finish<T, G, NV, VE>(sp.phi_s + grp * sp.kp, dense, out,
                              b * block_rows + r, k, lane, acc);
    if (g + 1 < groups) {  // the next block's span and run, from the copy
      const int* rn = runs_all + (g + 1) * (kRows + 1);
      cs = rn[0];
      ce = rn[kRows];
      cn = n_stages(cs, ce);
      if (live) {
        rs = rn[grp];
        re = rn[grp + 1];
      }
    }
  }
}

// B10's dynamic shared memory: HvSpan's ring, the first phi buffer and the
// slot values, the runs of G blocks (HvSpan's of one, extended), then the
// second phi buffer
template <typename T, int kRows>
inline size_t ring_bytes(int k, int slots, int groups) {
  const size_t ring = (size_t)kStages * slots * (k + 1) * sizeof(T);
  const size_t runs = ((size_t)groups * (kRows + 1) + 3) & ~(size_t)3;
  return ring + ((size_t)2 * kRows * (k + 4) + slots + runs) * sizeof(float);
}

template <typename T>
struct PosHvRingLaunch {
  const T* phi;
  const T* rows;
  const int* runs;
  const T *w, *dense;
  T* out;
  long long n_blocks;
  int maxc, k, block_rows, groups;
  float w_scale;
  cudaStream_t st;
  template <int G, int NV, int VE>
  int run() const {
    if constexpr (VE > 1 && G * NV * VE > 32) {
      return (int)cudaErrorInvalidValue;  // hv_staged admits k <= 32 only
    } else {
      const HvGrid g = hv_grid<T, G, VE, true>(n_blocks / groups, k,
                                               block_rows);
      const size_t smem =
          ring_bytes<T, kHvThreads / G>(k, g.stage_slots, groups);
      const auto kernel = pos_hv_ring_kernel<T, G, NV, VE>;
      if (smem > 48 * 1024) {  // many blocks per CTA: the opt-in, to 227 KB
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      kernel<<<g.grid, kHvThreads, smem, st>>>(phi, rows, runs, w, dense,
                                               out, maxc, k, block_rows,
                                               groups, w_scale,
                                               g.stage_slots);
      return (int)cudaGetLastError();
    }
  }
};

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

// runs: (n_blocks, block_rows + 1) row runs of slots
int ocffm_pos_hv_blocked_g(int dtype, const void* phi, const void* rows,
                           const void* runs, const void* w, const void* dense,
                           void* out, long long n_blocks, int maxc, int k,
                           int block_rows, int groups, float w_scale,
                           void* stream) {
  if (groups < 1 || n_blocks % groups != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {phi, rows, w, dense, out};
  const bool staged = hv_staged(k, maxc, dtype == kF32 ? 4 : 2, ptrs, 5);
  OCFFM_BY_DTYPE(dtype, return by_width<T>(k, staged, PosHvRingLaunch<T>{
      (const T*)phi, (const T*)rows, (const int*)runs, (const T*)w,
      (const T*)dense, (T*)out, n_blocks, maxc, k, block_rows, groups,
      w_scale, (cudaStream_t)stream}));
}

}  // extern "C"
