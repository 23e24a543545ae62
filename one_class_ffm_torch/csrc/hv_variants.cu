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
// so both give B1's bits.  Both run B1's CTA body (common.cuh HvSpan,
// hv_stage_dots, hv_stage_adds, hv_finish), read each row's run from the
// static run pointer (layout.row_runs) and read the stream once with O(k)
// flops per element read: they are bound by device-memory bandwidth.
//
// What the TPU layouts were for, and what is left of them here:
// - The packed layout (n_blocks, MAXC/4, 128) put four k = 32 entries in one
//   128-lane row so that the MXU's M dimension grew from k to MAXC/4; slot
//   e = j * MAXC/4 + c sits at [c, 32j:32j+32], and its owner and weight are
//   copied to all 32 lanes of the group.  A CTA's span of consecutive slots
//   is therefore a strip: 32 values of each of n consecutive 128-wide rows
//   (a 512-byte pitch at f32), jumping to row 0 of the next lane group at
//   each multiple of MAXC/4.  A 1-D bulk copy cannot gather a strip whose
//   pitch is not its width; a tensor-map (TMA) copy can.  B9's stages are
//   filled from two 3-D tensor maps, {128, MAXC/4, n_blocks} views of the
//   rows and of the weights: a box of 32 values of a stage's rows lands in
//   shared memory as those rows, row after row, which is B1's row-major
//   stage, and a box of 16 bytes of the same rows holds each slot's weight
//   in its first element (16 bytes is the least a box row can be).  The
//   owners are not read: the runs take their place.  So B9 is B1's kernel
//   with stages that never cross a lane group (PackedStream) and the
//   weights at a stride of 16 bytes; what it reads beyond B1 is one 32-byte
//   sector per slot for its weight (about 160 bytes per slot at f32 against
//   B1's 132, 96 against 66 at bf16), the layout's own cost.
// - G blocks per grid step amortised the TPU's per-step overhead.  On
//   Hopper a CTA of B1 (8 rows of k = 32) holds a span of ~35 slots on the
//   u side, one or two stages, and waits on its first bulk copy's latency
//   more than on bandwidth.  B10 runs B1's CTA body over the same rows of G
//   blocks with one ring of stages across them, so that block g + 1's first
//   stages are in flight while block g's last is computed.

#include <cuda.h>  // CUtensorMap and its encoder's types

#include "common.cuh"

using namespace ocffm;

namespace {

constexpr int kPackedK = 32;  // the packed layout's k: four slots per row

// Slots per stage, and rows per tensor-map box: one box of rows and one of
// weights fill a stage.  Timed on the H100 on u- and v-like streams (782 x
// 1376 and 79 x 11544 slots) at f32 and bf16, against stages of 32 and 128
// slots, three stages in the ring and boxes of 8 rows (which read less
// past a stage's last slot but take eight times the copies), this was the
// fastest overall: 64 slots are 8 KB of rows at f32 and 4 KB at bf16.
constexpr int kPackedSlots = 64;

// the box of a 3-D tensor map at coordinates {c0, c1, c2} (innermost
// first) into shared memory at dst (128-byte aligned), completed on bar;
// the parts of the box outside the tensor are filled with zeros
__device__ __forceinline__ void tensor_load_3d(void* dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// B9's stream layout (common.cuh RowStream says what a layout is): block
// blk of the lane-packed stream, slot e = j * m4 + c at row c, lanes
// 32j..32j+31 (m4 = MAXC / 4).  A stage holds consecutive slots of one lane
// group: stage j of the span [s, e) starts at s + j * slots while it stays
// in s's group, then at the start of each later group the span reaches and
// every `slots` slots after it, and ends at the earlier of `slots` slots
// on and the end of its group.  Thread 0 copies a stage as two boxes at
// {32j, c, blk}: `slots` rows of 32 values from rows_map, and as many rows
// of 16 bytes from w_map (the slot's weight first, so kWStride = 16 /
// sizeof(T)).  A box that runs past the group's m4 rows is filled with
// zeros there (the maps' second extent is m4): it never reads the next
// block, and no row of a box past its stage's slots is used.  m4 % 8 need
// not be 0: the boxes start anywhere.
template <typename T>
struct PackedStream {
  const CUtensorMap* rows_map;
  const CUtensorMap* w_map;
  int m4, blk;
  static constexpr int kWStride = 16 / (int)sizeof(T);

  __device__ __forceinline__ int first(int s) const { return s; }
  // the end of the lane group of slot t
  __device__ __forceinline__ int group_end(int t) const {
    return (t / m4 + 1) * m4;
  }
  __device__ __forceinline__ int stages(int s, int e, int slots) const {
    if (s >= e) return 0;
    const int b0 = group_end(s);
    const int n0 = (min(e, b0) - s + slots - 1) / slots;
    if (e <= b0) return n0;
    const int per = (m4 + slots - 1) / slots;  // stages of a whole group
    const int rest = e - b0;
    return n0 + rest / m4 * per + (rest % m4 + slots - 1) / slots;
  }
  __device__ __forceinline__ int start(int j, int, int s, int e,
                                       int slots) const {
    const int b0 = group_end(s);
    const int n0 = (min(e, b0) - s + slots - 1) / slots;
    if (j < n0) return s + j * slots;
    const int per = (m4 + slots - 1) / slots;
    const int q = j - n0;
    return b0 + q / per * m4 + q % per * slots;
  }
  __device__ __forceinline__ int stop(int ws, int slots) const {
    return min(ws + slots, group_end(ws));
  }

  template <bool kWeighted>
  __device__ __forceinline__ void copy(T* buf, T* buf_w, uint64_t* bar,
                                       int ws, int, int, int slots) const {
    static_assert(kWeighted, "B9 reads its weights");
    const int j = ws / m4, c = ws - j * m4;
    // a box is written whole, its zero fill included
    mbar_expect_tx(bar, (uint32_t)(slots * (kPackedK + kWStride) *
                                   sizeof(T)));
    tensor_load_3d(buf, rows_map, 32 * j, c, blk, bar);
    tensor_load_3d(buf_w, w_map, 32 * j, c, blk, bar);
  }
};

// B9, replacing pos_hv_packed_pallas (scripts/hv_pack_bench.py): B1's CTA
// body (common.cuh hv_rows) on the lane-packed stream, at k = 32 on the
// width plan of 16-byte vectors (f32: 8 lanes per row, bf16: 4), with
// stages of kPackedSlots slots (compile-time constants, as the box is).
// The maps are kernel parameters (__grid_constant__), so the copies read
// them where the launch put them.
template <typename T, int G, int VE>
__global__ void __launch_bounds__(kHvThreads)
pos_hv_packed_kernel(const __grid_constant__ CUtensorMap rows_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const T* __restrict__ phi, const int* __restrict__ runs,
                     const T* __restrict__ dense, T* __restrict__ out, int m4,
                     int block_rows, float w_scale) {
  hv_rows<T, G, 1, VE>(RowPhi<T>{phi, kPackedK},
                       PackedStream<T>{&rows_map, &w_map, m4,
                                       (int)blockIdx.x},
                       runs, dense, out, kPackedK, block_rows, w_scale,
                       kPackedSlots);
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
  HvSpan<T, kRows, true> sp(hv_smem, full, RowStream<T>{rows, w}, k,
                            stage_slots);
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
    sp.issue_at(iJ, RowStream<T>{rows + b * maxc * k, w + b * maxc},
                (is & ~7) + ij * stage_slots, ie);
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

// cuTensorMapEncodeTiled of the CUDA driver API, found through the CUDA
// runtime once (so the library links against the runtime alone); null if
// the installed CUDA driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The packed array (n_blocks, m4, 128) of T at base as a 3-D tensor map
// {128, m4, n_blocks}, its box `width` values of a stage's kPackedSlots
// rows of one block, no swizzle, zeros outside the array.  Returns the
// encoder's result.
template <typename T>
CUresult packed_map(CUtensorMap* map, const void* base, long long n_blocks,
                    int m4, int width) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {128, (cuuint64_t)m4, (cuuint64_t)n_blocks};
  const cuuint64_t strides[2] = {128 * sizeof(T), (cuuint64_t)m4 * 128 *
                                                      sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)width, kPackedSlots, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// B9's launch: HvSpan's geometry on the packed stream (stages of
// kPackedSlots slots), the two maps encoded here, on the host, for each
// call
template <typename T>
int pos_hv_packed_launch(const void* phi, const void* rows_p,
                         const void* runs, const void* w_p, const void* dense,
                         void* out, long long n_blocks, int m4,
                         int block_rows, float w_scale, cudaStream_t st) {
  constexpr int VE = 16 / (int)sizeof(T), G = kPackedK / VE;
  using Stream = PackedStream<T>;
  const HvGrid g = hv_grid<T, G, VE, true, Stream>(
      n_blocks, kPackedK, block_rows, kPackedSlots * kPackedK * sizeof(T));
  CUtensorMap rows_map, w_map;
  CUresult res = packed_map<T>(&rows_map, rows_p, n_blocks, m4, kPackedK);
  if (res == CUDA_SUCCESS)
    res = packed_map<T>(&w_map, w_p, n_blocks, m4, Stream::kWStride);
  if (res != CUDA_SUCCESS) return (int)res;
  pos_hv_packed_kernel<T, G, VE><<<g.grid, kHvThreads, g.smem, st>>>(
      rows_map, w_map, (const T*)phi, (const int*)runs, (const T*)dense,
      (T*)out, m4, block_rows, w_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows_p, w_p: (n_blocks, m4, 128) packed rows and weights, 16-byte
// aligned (the tensor maps need it; phi, dense and out are read and
// written as 16-byte vectors); runs: (n_blocks, block_rows + 1) row runs
// of slots.  A failed map encoding returns its CUresult.
int ocffm_pos_hv_packed(int dtype, const void* phi, const void* rows_p,
                        const void* runs, const void* w_p, const void* dense,
                        void* out, long long n_blocks, int m4,
                        int block_rows, float w_scale, void* stream) {
  const void* ptrs[] = {phi, rows_p, w_p, dense, out};
  if (!vec_ok(kPackedK, dtype == kF32 ? 4 : 2, ptrs, 5))
    return (int)cudaErrorMisalignedAddress;
  OCFFM_BY_DTYPE(dtype, return pos_hv_packed_launch<T>(
      phi, rows_p, runs, w_p, dense, out, n_blocks, m4, block_rows, w_scale,
      (cudaStream_t)stream));
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
