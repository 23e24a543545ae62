// Hopper (sm_90a) kernel: each row's top K of a float32 or bfloat16 score
// matrix, in the order of a stable descending sort of the row (the highest
// value first, the lowest column first among equal values).  Built with the
// other sources into one shared library (ops/kernels.py), bound with ctypes.
//
// Replaces jax.lax.top_k in predict's ranking
// (one_class_ffm_tpu/predict.py:114) and the item-sharded evaluator's local
// top-K and merge (one_class_ffm_tpu/evalx/sharded_topk.py).  torch.topk
// promises no order among equal values, so the port had ranked by a stable
// sort of the whole row, which reads and writes the row's keys and int64
// indices several times to keep ten columns.
//
// Exact by construction: every element is ranked by one 64-bit key,
//   (ordered_u32(value) << 32) | (0xFFFFFFFF - column),
// where ordered_u32 maps a float to an unsigned integer in the order in
// which the card's torch.sort ranks values: the radix sort's map (the sign
// bit set for a positive value, every bit flipped for a negative one) after
// folding -0.0 onto +0.0, so that NaNs rank by their bits (tests/
// test_torch_topk.py pins that order on the card).  A bfloat16 is widened
// to the float with its bits in the upper half, which is exact and keeps
// that order, so both storage types share the key.  No two keys of a row
// are equal, so the K largest keys are exactly the stable descending sort's
// first K, whatever order the threads and CTAs see the elements in: no
// ordered atomics, and two launches give the same bits.  The values written
// are the row's own elements, read again at the chosen columns, at the
// storage type.
//
// Bound on the H100: bytes.  The scores are read once (rows x n x 4 bytes
// at float32, 2 at bfloat16; at 1,024 x 359,966 float32 that is 1.47 GB,
// 0.44 ms at 3.35 TB/s) and the output is rows x K x (8 + the storage's
// size) bytes.  A warp streams its slice of a row with 16-byte evict-first
// loads (__ldcs: four floats or eight bfloat16), kLoads of them in flight a
// lane, and offers each group of four elements' keys only where one beats
// the warp's threshold: passing lanes append to the warp's candidate buffer
// in shared memory by a ballot and a prefix count.  When the next offer
// could overflow the buffer, the warp sorts the slots in use (a bitonic
// sort, the warp alone, __syncwarp only), keeps the best keys and raises
// the threshold to the K-th.  Those sorts are what
// costs beyond the stream (shared-memory bandwidth), so the threshold
// starts just below the K-th best of the first batch's group maxima (a
// lane's kLoads vectors for K <= 32, each 16-byte vector for K <= 128): the
// first batch then offers about K elements, not 512.  On scores like a
// catalog's a slice then sees about K ln(n / K) insertions in all, and the
// pass is a stream; an ascending row, where every element beats the
// threshold, stays correct at a sort per few hundred elements.  Then warp 0
// merges its CTA's warps, and the last CTA of a row (an atomic ticket per
// row, reset by that CTA) merges the row's S segments and writes the K
// values and int64 ids.  A row's head up to its first 16-byte boundary and
// its tail past the last whole vector are read one element a lane; the row
// stride is an argument, so a column slice of a wider matrix needs no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTopkThreads = 256;
constexpr int kTopkWarps = kTopkThreads / 32;
constexpr int kLoads = 4;  // 16-byte loads in flight a lane
constexpr int kOffer = 32 * 4;  // keys a warp offers at once: four a lane
// Segments a row.  Each segment pays its warps' own insertions (about
// K ln(n / K) a warp) and the row's last CTA merges S x K keys, so a row
// is split only where the rows alone would leave SMs idle: up to
// 2 x 16 / KPAD CTAs an SM, each warp at least kMinRounds rounds of loads
// (H100, 359,966 float32 columns, ms at one segment a row / at the rule's
// count: 1 row K=10 0.111 / 0.038 (21), K=80 0.212 / 0.124 (21); 16 rows
// K=10 0.120 / 0.050 (17), K=80 0.224 / 0.160 (3); 64 rows K=10 0.123 /
// 0.077 (5); from 64 rows at K=80 and 256 at K=10 the rule's one or two
// segments are within 5% of one)
constexpr int kCtasPerSmK16 = 2;
constexpr int kMinRounds = 4;
constexpr unsigned kAll = 0xffffffffu;

// the radix sort's order of a float with -0.0 folded onto +0.0, as the
// card's torch.sort ranks them (NaNs by their bits: a NaN with the sign bit
// set below -inf, one without above +inf)
__device__ __forceinline__ uint32_t ordered_u32(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float x, uint32_t col) {
  return ((u64)ordered_u32(x) << 32) | (u64)(0xffffffffu - col);
}

__device__ __forceinline__ uint32_t key_col(u64 key) {
  return 0xffffffffu - (uint32_t)key;
}

// s[0, p) sorted descending by one warp (p a power of two, at least 2)
__device__ void warp_sort(u64* s, int p, int lane) {
#pragma unroll 1
  for (int size = 2; size <= p; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < p / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 a = s[lo], b = s[hi];
        if ((a < b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

// A warp's running top: buf[0, KPAD) the best keys so far, sorted
// descending at the last flush, buf[KPAD, KPAD + c) the candidates offered
// since.  A key that does not beat thr cannot be among the row's top k: thr
// is the k-th best key at the last flush (0 before, and while fewer than k
// were seen: no real key is 0), or just below the k-th best of a batch's
// group maxima (seed).
template <int KPAD, int SORT>
struct WarpTop {
  static_assert(SORT - KPAD >= kOffer, "room for an offer");
  static constexpr int kCap = SORT - KPAD;
  u64* buf;
  int k, lane, c;
  u64 thr;

  __device__ void init(u64* b, int k_, int lane_) {
    buf = b;
    k = k_;
    lane = lane_;
    c = 0;
    thr = 0ull;
    for (int i = lane; i < KPAD; i += 32) buf[i] = 0ull;
    __syncwarp();
  }

  // sort the slots in use descending (the top and the candidates, padded
  // with 0 to a power of two), keep the best in front, raise thr
  __device__ void flush() {
    int p = 32;
    while (p < KPAD + c) p <<= 1;
    for (int i = KPAD + c + lane; i < p; i += 32) buf[i] = 0ull;
    __syncwarp();
    warp_sort(buf, p, lane);
    thr = buf[k - 1];
    c = 0;
  }

  // before the warp's first offers (c == 0): thr just below the k-th best
  // of the batch's group maxima gm (k groups hold k keys at least that
  // high, all offered next), kG groups a lane
  template <int kG>
  __device__ void seed(const u64 (&gm)[kG]) {
    u64* s = buf + KPAD;
#pragma unroll
    for (int j = 0; j < kG; ++j) s[j * 32 + lane] = gm[j];
    __syncwarp();
    warp_sort(s, kG * 32, lane);
    const u64 kth = s[k - 1];
    __syncwarp();
    if (kth > 0ull) thr = kth - 1ull;
  }

  // make room for `need` more candidates (warp-uniform)
  __device__ __forceinline__ void room(int need) {
    if (c + need > kCap) flush();
  }

  __device__ __forceinline__ void push(bool pass, u64 key) {
    const unsigned m = __ballot_sync(kAll, pass);
    if (pass) buf[KPAD + c + __popc(m & ((1u << lane) - 1u))] = key;
    c += __popc(m);
  }

  // one key a lane (0 for none)
  __device__ __forceinline__ void offer(u64 key) {
    if (!__any_sync(kAll, key > thr)) return;
    room(32);
    push(key > thr, key);
  }

  // four keys a lane (0 for none)
  __device__ __forceinline__ void offer4(const u64 (&kk)[4], u64 best) {
    if (!__any_sync(kAll, best > thr)) return;
    room(kOffer);
#pragma unroll
    for (int i = 0; i < 4; ++i) push(kk[i] > thr, kk[i]);
  }

  // the first k keys of a sorted run of another top
  template <bool kGlobal>
  __device__ void offer_run(const u64* run) {
    for (int i = 0; i < k; i += 32) {
      u64 key = 0ull;
      if (i + lane < k) key = kGlobal ? __ldcg(run + i + lane) : run[i + lane];
      offer(key);
    }
  }

  __device__ void finish() {
    if (c > 0) flush();
  }
};

// a storage element as the float whose order its key takes: bfloat16 (its
// bits, uint16_t here) widened exactly
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// group g of a 16-byte vector's elements, four at a time, as floats (a
// bfloat16 vector holds two groups: the lower address in a word's low half)
template <typename T>
__device__ __forceinline__ void group_of(const float4& x, int g, float (&e)[4]);
template <>
__device__ __forceinline__ void group_of<float>(const float4& x, int,
                                                float (&e)[4]) {
  e[0] = x.x;
  e[1] = x.y;
  e[2] = x.z;
  e[3] = x.w;
}
template <>
__device__ __forceinline__ void group_of<uint16_t>(const float4& x, int g,
                                                   float (&e)[4]) {
  const uint32_t w0 = __float_as_uint(g ? x.z : x.x);
  const uint32_t w1 = __float_as_uint(g ? x.w : x.y);
  e[0] = __uint_as_float(w0 << 16);
  e[1] = __uint_as_float(w0 & 0xffff0000u);
  e[2] = __uint_as_float(w1 << 16);
  e[3] = __uint_as_float(w1 & 0xffff0000u);
}

// the keys of group g of vector x, whose first element is column col (0
// for none where !in); returns their largest
template <typename T>
__device__ __forceinline__ u64 group_keys(const float4& x, int g,
                                          uint32_t col, bool in,
                                          u64 (&kk)[4]) {
  float e[4];
  group_of<T>(x, g, e);
#pragma unroll
  for (int i = 0; i < 4; ++i) kk[i] = in ? make_key(e[i], col + i) : 0ull;
  return max(max(kk[0], kk[1]), max(kk[2], kk[3]));
}

template <typename T, int KPAD, int SORT>
__global__ void __launch_bounds__(kTopkThreads)
topk_rows_kernel(const T* __restrict__ z, long long ld, int n, int k,
                 int segs, T* __restrict__ vals,
                 long long* __restrict__ ids, u64* part,
                 unsigned* tickets) {
  constexpr int kV = 16 / sizeof(T);  // elements a 16-byte vector
  constexpr int kG = kV / 4;          // groups of four keys a vector
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x / segs;
  const int seg = blockIdx.x % segs;
  const T* zr = z + row * ld;
  WarpTop<KPAD, SORT> top;
  top.init(smem + warp * SORT, k, lane);

  // the row's head (to its first 16-byte boundary), vectors and tail
  const int head = min(
      n, (int)(((16u - ((uintptr_t)zr & 15u)) & 15u) / sizeof(T)));
  const long long nv = (n - head) / kV;
  const int tail = head + (int)(kV * nv);
  const float4* zv = reinterpret_cast<const float4*>(zr + head);
  const int nw = segs * kTopkWarps, w = seg * kTopkWarps + warp;
  const long long vb = nv * w / nw, ve = nv * (w + 1) / nw;
  for (long long v0 = vb; v0 < ve; v0 += 32 * kLoads) {
    float4 x[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long v = v0 + j * 32 + lane;
      if (v < ve) x[j] = __ldcs(zv + v);
    }
    if (v0 == vb && k <= 4 * 32) {
      // the first batch: a lane's maximum (k <= 32) or each vector's
      u64 vm[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const long long v = v0 + j * 32 + lane;
        const uint32_t col = (uint32_t)(head + kV * v);
        vm[j] = 0ull;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          u64 kk[4];
          vm[j] = max(vm[j], group_keys<T>(x[j], g, col + 4 * g, v < ve, kk));
        }
      }
      if (k <= 32) {
        u64 m[1] = {vm[0]};
#pragma unroll
        for (int j = 1; j < kLoads; ++j) m[0] = max(m[0], vm[j]);
        top.seed(m);
      } else {
        top.seed(vm);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long v = v0 + j * 32 + lane;
      const uint32_t col = (uint32_t)(head + kV * v);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        u64 kk[4];
        const u64 best = group_keys<T>(x[j], g, col + 4 * g, v < ve, kk);
        top.offer4(kk, best);
      }
    }
  }
  if (w == 0) top.offer(lane < head ? make_key(widen(zr[lane]), lane) : 0ull);
  if (w == nw - 1)
    top.offer(tail + lane < n
                  ? make_key(widen(zr[tail + lane]), tail + lane)
                  : 0ull);
  top.finish();

  // warp 0 takes the CTA's other warps' tops
  __syncthreads();
  if (warp != 0) return;
  for (int o = 1; o < kTopkWarps; ++o)
    top.template offer_run<false>(smem + o * SORT);
  top.finish();

  if (segs > 1) {
    // the last CTA of the row to finish merges the row's segments
    u64* mine = part + (row * segs + seg) * k;
    for (int i = lane; i < k; i += 32) mine[i] = top.buf[i];
    __threadfence();
    __syncwarp();
    unsigned last = 0u;
    if (lane == 0) last = atomicAdd(tickets + row, 1u) == (unsigned)segs - 1u;
    if (!__shfl_sync(kAll, last, 0)) return;
    if (lane == 0) tickets[row] = 0u;  // every CTA of the row has its ticket
    __threadfence();
    for (int s = 0; s < segs; ++s)
      if (s != seg) top.template offer_run<true>(part + (row * segs + s) * k);
    top.finish();
  }
  for (int i = lane; i < k; i += 32) {
    const uint32_t col = key_col(top.buf[i]);
    vals[row * k + i] = zr[col];
    ids[row * k + i] = (long long)col;
  }
}

// a warp's slots: its top and room for at least 192 candidates
constexpr int sort_slots(int kpad) { return kpad <= 64 ? 256 : 512; }

template <typename T, int KPAD>
struct TopkKernel {
  static constexpr int kSort = sort_slots(KPAD);
  static constexpr size_t kSmem = (size_t)kTopkWarps * kSort * sizeof(u64);

  // segments a row (see kCtasPerSmK16)
  static int segs(long long rows, long long n) {
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (long long)kCtasPerSmK16 * n_sm * 16 / KPAD;
    long long s = (want + rows - 1) / rows;
    const long long most = n / ((16 / (long long)sizeof(T)) * kTopkWarps *
                                32 * kLoads * kMinRounds);
    if (s > most) s = most;
    return (int)(s > 1 ? s : 1);
  }

  static int run(const void* z, long long ld, long long rows, int n, int k,
                 int segs_, void* vals, long long* ids, void* part,
                 unsigned* tickets, cudaStream_t st) {
    topk_rows_kernel<T, KPAD, kSort>
        <<<(unsigned)(rows * segs_), kTopkThreads, kSmem, st>>>(
            (const T*)z, ld, n, k, segs_, (T*)vals, ids, (u64*)part,
            tickets);
    return (int)cudaGetLastError();
  }
};

template <typename T, typename F>
int by_bucket(int k, F f) {
  if (k <= 16) return f(TopkKernel<T, 16>{});
  if (k <= 32) return f(TopkKernel<T, 32>{});
  if (k <= 64) return f(TopkKernel<T, 64>{});
  if (k <= 128) return f(TopkKernel<T, 128>{});
  return f(TopkKernel<T, 256>{});
}

// the storage type of dtype code dt (0 float32, 1 bfloat16) and k's bucket
template <typename F>
int by_type(int dt, int k, F f) {
  if (dt == 0) return by_bucket<float>(k, f);
  if (dt == 1) return by_bucket<uint16_t>(k, f);
  return -1;
}

}  // namespace

extern "C" {

// segments a row of the launch for (rows, n, k) at dtype code dt
int ocffm_topk_segs(int dt, long long rows, int n, int k) {
  return by_type(dt, k, [&](auto t) { return t.segs(rows, n); });
}

int ocffm_topk_rows(int dt, const void* z, long long ld, long long rows,
                    int n, int k, int segs, void* vals, void* ids,
                    void* part, void* tickets, void* stream) {
  if (k < 1 || k > 256 || k > n || segs < 1 || (dt != 0 && dt != 1))
    return (int)cudaErrorInvalidValue;
  return by_type(dt, k, [&](auto t) {
    return t.run(z, ld, rows, n, k, segs, vals, (long long*)ids, part,
                 (unsigned*)tickets, (cudaStream_t)stream);
  });
}

}  // extern "C"
