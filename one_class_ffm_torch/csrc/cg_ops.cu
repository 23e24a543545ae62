// Hopper (sm_90a) kernel K2: the recurrence of a Newton solve's conjugate
// gradient, after each Hv, with the stop rule on the card.  Built with the
// other sources into one shared library (ops/kernels.py), bound with ctypes.
//
// Replaces the body and the cond of the reference's CG while_loop
// (one_class_ffm_tpu/solver/jax_solver.py FFMSolver._cg: jax.lax.while_loop
// over cond / body, the den > 0 guard in the body; the start, S0, V0, g2
// and rz0, is cg_init_kernel).  There XLA fuses the recurrence into the
// loop's program and the stop test never leaves the device.  Here one
// iteration after the Hv is one launch of cg_iter_kernel over the solve's
// vectors (f32, the recurrence's floor, as the reference's), in three
// stages split by two grid-wide barriers:
//   1. den = sum V Hv; alpha = rz / den where den > 0, else 0
//   2. S += alpha V; R -= alpha Hv; Z = R / D (Jacobi); r2 = sum R R (0
//      where den <= 0), rz = sum R Z (or r2); beta = rz / (old rz > 0 ?
//      old rz : 1); it += 1; done = !(it < cg_max_iter && r2 > cg_eps g2)
//   3. V = Z + beta V, and V rounded to storage for the Hv
// Every scalar (g2, r2, rz, alpha, beta, the threshold, the count, the done
// flag, the barrier's word) lives in one CgScalars block per solve on the
// card; the host reads only the count and the flag, once per group of
// iterations.  Every CTA reads the flag before the first barrier, and a
// launch on a stopped solve writes nothing, so the iterations a CUDA graph
// replays after the stop are exact no-ops.
//
// Sums: in the order of torch's CUDA sum of a contiguous float32 tensor
// into one output (ATen/native/cuda/Reduce.cuh), so that the loop on the
// card gives the bits of the eager torch loop it replaced.  That order is
// a *virtual* launch (ops/kernels.py cg_config): a row of `threads` threads
// (a power of two, at most 512) in `ctas` CTAs; from n = 128 each thread
// adds its grid-strided loads of 4 elements in 4 accumulators, lane by
// lane, the first n % 4 threads of CTA 0 add the tail into the first, and
// ((a0 + a1) + a2) + a3 is the thread's value; below 128 each thread adds
// its elements t and t + threads.  A CTA halves its values through shared
// memory down to one warp, and the warp's shuffles down at offsets 16 .. 1
// finish; past one CTA, thread t adds the CTAs' partials t, t + threads,
// ... from 0 and halves those the same way.  The hardware launch
// (ops/kernels.py cg_plan) need not be the virtual one: a hardware CTA of
// the same width carries `per` virtual CTAs (j * grid + blockIdx.x), one
// halving tree each, so that the whole grid is resident for its barriers;
// after each barrier every CTA forms the grid's sum itself, in the order
// above, and all hold the same bits of alpha and beta.  Products and sums
// are rounded one at a time (__fmul_rn / __fadd_rn, no fused multiply-add),
// the divisions by __fdiv_rn, as torch's eager operations round;
// sparse_ops.cg_init_plain and cg_step_plain sum with torch's own sum and
// agree with these kernels bit for bit on the card (tests/test_torch_cuda.py
// holds them; tests/test_torch_cg_plan.py models the hardware launch on the
// CPU against the virtual one).  No float atomics: two runs give the same
// bits.
//
// Bound on the H100: bytes.  Per iteration the recurrence must read S, R,
// V, Hv (and D) and write S, R, V (and V at storage): 7 passes over the
// vectors at f32, a handful of flops per element, far below the 20 flops a
// byte where f32 arithmetic would bind.  One launch instead of three: the
// stages read V twice more and R once more than that, so each thread keeps
// the V of its first `cache` loads in shared memory from stage 1 to stage 3
// (at 200,000 x 32 all of them: 96 KB a CTA, two CTAs an SM); Hv and R,
// read again in the next stage, are left in L2 (S, R and the second Hv read
// with the evict-first hint).  Every access is one 16-byte load or store
// of 4 elements (8 bytes at bf16 storage) where the arrays are aligned.
// cg_init_kernel: one launch of torch's virtual grid, each thread's loads
// of G (and D) in flight in batches before their adds, the grid's sums in
// the CTA that takes the last ticket.

#include <type_traits>

#include "common.cuh"

using namespace ocffm;

namespace {

constexpr int kCgMaxThreads = 512;  // Reduce.cuh's widest CTA
constexpr int kCgMinBlocks = 2;     // CTAs of 512 an SM: 64 registers

// a solve's scalars, one block on the card (ops/kernels.py CG_WORDS words
// of 4 bytes; the host reads `it` and `done`)
struct CgScalars {
  float g2, r2, rz, alpha, beta, thr;
  int it, done, active, ok;
  unsigned ticket;  // cg_init's count of finished CTAs, 0 between launches
  unsigned bar;     // cg_iter's grid barrier: its top bit flips at each one
  int unused[4];
};
static_assert(sizeof(CgScalars) == 64, "CgScalars is 16 words");

// kStream: the evict-first hint (ld.cs / st.cs) for an access whose line
// is not read again in this launch, so that L2 keeps those that are (Hv
// and R, read again in the next stage).  Hopper's evict-last policy on Hv
// and R (createpolicy, L2::cache_hint) measured slower on the H100, and no
// hint slower still (PERF.md, the K2 row of its kernel table).
enum Hint { kPlain, kStream };

template <Hint H>
__device__ __forceinline__ float4 ld16(const float* p) {
  if constexpr (H == kStream) return __ldcs(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}
template <Hint H>
__device__ __forceinline__ uint2 ld8(const void* p) {
  if constexpr (H == kStream) return __ldcs(reinterpret_cast<const uint2*>(p));
  else return *reinterpret_cast<const uint2*>(p);
}
template <Hint H>
__device__ __forceinline__ void st16(float* p, float4 v) {
  if constexpr (H == kStream) __stcs(reinterpret_cast<float4*>(p), v);
  else *reinterpret_cast<float4*>(p) = v;
}
template <Hint H>
__device__ __forceinline__ void st8(void* p, uint2 v) {
  if constexpr (H == kStream) __stcs(reinterpret_cast<uint2*>(p), v);
  else *reinterpret_cast<uint2*>(p) = v;
}

// elements e .. e + 3 (e a multiple of 4): one 16-byte access (8 at bf16)
// where the array is aligned (`al`), else four
template <typename T, Hint H>
__device__ __forceinline__ void ld4(const T* p, long long e, bool al,
                                    float (&f)[4]) {
  if (al) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 v = ld16<H>(p + e);
      f[0] = v.x;
      f[1] = v.y;
      f[2] = v.z;
      f[3] = v.w;
    } else {
      const uint2 u = ld8<H>(p + e);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      f[0] = __low2float(lo);
      f[1] = __high2float(lo);
      f[2] = __low2float(hi);
      f[3] = __high2float(hi);
    }
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) f[l] = to_f(p[e + l]);
  }
}

template <typename T, Hint H>
__device__ __forceinline__ void st4(T* p, long long e, bool al,
                                    const float (&f)[4]) {
  if (al) {
    if constexpr (std::is_same<T, float>::value) {
      st16<H>(p + e, make_float4(f[0], f[1], f[2], f[3]));
    } else {
      // round to nearest even, as from_f (torch's .to())
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      st8<H>(p + e, u);
    }
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) p[e + l] = from_f<T>(f[l]);
  }
}

__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// Reduce.cuh's block_x_reduce of nq rows of the CTA's values at once: row
// q is vals[q * T .. q * T + T), one value per thread; halving through
// shared memory down to a warp, then shuffles down at offsets 16 .. 1.  Row
// q's sum lands in vals[q * T], read by any thread on return.  Every
// thread must call it.
__device__ __forceinline__ void cta_trees(float* vals, int nq) {
  const int T = blockDim.x, t = threadIdx.x;
  for (int off = T / 2; off >= 32; off >>= 1) {
    __syncthreads();
    if (t < off)
      for (int q = 0; q < nq; ++q)
        vals[q * T + t] = __fadd_rn(vals[q * T + t], vals[q * T + t + off]);
  }
  __syncthreads();
  const int width = T < 32 ? T : 32;
  const unsigned mask = width >= 32 ? kFull : (1u << width) - 1u;
  const int lane = t & 31, nw = (T + 31) >> 5;
  for (int q = t >> 5; q < nq; q += nw) {
    float v = vals[q * T + lane];
    for (int off = width >> 1; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(mask, v, off));
    if (lane == 0) vals[q * T] = v;
  }
  __syncthreads();
}

// The grid's nq sums of the partials part[q * nb .. q * nb + nb) in this
// CTA: thread t adds t, t + T, ... from 0 (through L2), then the halving
// tree; out[q] in every thread.
__device__ __forceinline__ void grid_finish(const float* part, int nb,
                                            int nq, float* vals,
                                            float* out) {
  const int T = blockDim.x, t = threadIdx.x;
  for (int q = 0; q < nq; ++q) {
    float v = 0.f;
    for (int i = t; i < nb; i += T) v = __fadd_rn(v, __ldcg(part + q * nb + i));
    vals[q * T + t] = v;
  }
  cta_trees(vals, nq);
  for (int q = 0; q < nq; ++q) out[q] = vals[q * T];
  __syncthreads();  // vals is the next stage's
}

// A barrier of the whole grid (cooperative_groups' grid sync on a counter
// of the solve's own): CTA 0 adds 2^31 - (grid - 1), the others 1, so the
// counter's top bit flips once all have arrived and its low bits return
// to where they were; each CTA waits for the flip.  The grid must be
// resident (a cooperative launch: refused otherwise).
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1u) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    while (((old ^ *reinterpret_cast<volatile unsigned*>(bar)) &
            0x80000000u) == 0u)
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// One stage's sums over the grid, in every thread: the CTA's trees of its
// virtual CTAs (vals row q * per + j: sum q of virtual CTA j * grid +
// blockIdx.x), then past one virtual CTA their partials to part[q * ctas
// + c], the barrier, and the grid's sums.
__device__ __forceinline__ void stage_sums(float* vals, int nq, int per,
                                           int ctas, float* part,
                                           unsigned* bar, float* out) {
  const int T = blockDim.x, t = threadIdx.x;
  cta_trees(vals, nq * per);
  if (ctas == 1) {  // one virtual CTA (and one hardware CTA)
    for (int q = 0; q < nq; ++q) out[q] = vals[q * T];
    __syncthreads();
    return;
  }
  if (t < nq * per) {
    const int q = t / per, c = (t % per) * (int)gridDim.x + blockIdx.x;
    if (c < ctas) {
      part[q * ctas + c] = vals[t * T];
      __threadfence();
    }
  }
  grid_sync(bar);
  grid_finish(part, ctas, nq, vals, out);
}

// The loop of virtual thread gt (of virtual CTA c) over its elements in
// Reduce.cuh's order: fv(e, k, x, y) for its k-th load of 4 at element e,
// fs(e, x, y) for a single element (the tail, or below 128 elements);
// returns ((a0 + a1) + a2) + a3 of each sum (one, two with kTwo).
template <bool kTwo, typename FV, typename FS>
__device__ __forceinline__ void thread_sums(long long n, bool vec,
                                            long long gt, long long span,
                                            bool first_cta, FV fv, FS fs,
                                            float& a, float& b) {
  float la[4] = {0.f, 0.f, 0.f, 0.f}, lb[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    const long long nv = n >> 2;
    int k = 0;
    for (long long idx = gt; idx < nv; idx += span, ++k) {
      float x[4], y[4];
      fv(idx * 4, k, x, y);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        la[l] = __fadd_rn(la[l], x[l]);
        if (kTwo) lb[l] = __fadd_rn(lb[l], y[l]);
      }
    }
    const int tail = (int)(n & 3);
    if (first_cta && (int)threadIdx.x < tail) {
      float x, y;
      fs(n - tail + threadIdx.x, x, y);
      la[0] = __fadd_rn(la[0], x);
      if (kTwo) lb[0] = __fadd_rn(lb[0], y);
    }
  } else {
    for (int l = 0; l < 2; ++l) {
      const long long e = gt + l * span;
      if (e < n) {
        float x, y;
        fs(e, x, y);
        la[l] = __fadd_rn(la[l], x);
        if (kTwo) lb[l] = __fadd_rn(lb[l], y);
      }
    }
  }
  a = sum4(la);
  if (kTwo) b = sum4(lb);
}

// The same elements without sums (stage 3).
template <typename FV, typename FS>
__device__ __forceinline__ void thread_each(long long n, bool vec,
                                            long long gt, long long span,
                                            bool first_cta, FV fv, FS fs) {
  if (vec) {
    const long long nv = n >> 2;
    int k = 0;
    for (long long idx = gt; idx < nv; idx += span, ++k) fv(idx * 4, k);
    const int tail = (int)(n & 3);
    if (first_cta && (int)threadIdx.x < tail) fs(n - tail + threadIdx.x);
  } else {
    for (int l = 0; l < 2; ++l) {
      const long long e = gt + l * span;
      if (e < n) fs(e);
    }
  }
}

// The start: S = 0, R = -G, V = -G (Jacobi: -G / D) and V at storage;
// g2 = sum G G, rz = g2 (Jacobi: sum G (G / D)), r2 = g2, thr = eps g2,
// it = 0, done = !(0 < max_iter && g2 > thr).  Launched on torch's virtual
// grid itself; each thread issues kB loads of G (and D) before their adds.
template <typename T, bool kJac>
__global__ void __launch_bounds__(kCgMaxThreads, kCgMinBlocks) cg_init_kernel(
    const float* __restrict__ G, const float* __restrict__ D,
    float* __restrict__ S, float* __restrict__ R, float* V, T* Vs,
    float* __restrict__ part, CgScalars* sc, long long n, int vec, int al,
    float eps, int max_iter) {
  constexpr int kB = kJac ? 2 : 4;
  __shared__ float vals[2 * kCgMaxThreads];
  __shared__ int last;
  const int nt = blockDim.x, t = threadIdx.x;
  const long long gt = (long long)blockIdx.x * nt + t;
  const long long span = (long long)gridDim.x * nt;
  float la[4] = {0.f, 0.f, 0.f, 0.f}, lb[4] = {0.f, 0.f, 0.f, 0.f};
  auto one = [&](long long e, float g, float d, int l) {
    const float z = kJac ? __fdiv_rn(g, d) : g;
    S[e] = 0.f;
    R[e] = -g;
    V[e] = -z;
    if constexpr (!std::is_same<T, float>::value) Vs[e] = from_f<T>(-z);
    la[l] = __fadd_rn(la[l], __fmul_rn(g, g));
    if (kJac) lb[l] = __fadd_rn(lb[l], __fmul_rn(g, z));
  };
  if (vec) {
    const long long nv = n >> 2;
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long base = gt; base < nv; base += kB * span) {
      float g[kB][4], d[kB][4];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const long long idx = base + u * span;
        if (idx < nv) {
          ld4<float, kStream>(G, idx * 4, al, g[u]);
          if (kJac) ld4<float, kStream>(D, idx * 4, al, d[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const long long idx = base + u * span;
        if (idx < nv) {
          float r[4], v[4];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const float z = kJac ? __fdiv_rn(g[u][l], d[u][l]) : g[u][l];
            r[l] = -g[u][l];
            v[l] = -z;
            la[l] = __fadd_rn(la[l], __fmul_rn(g[u][l], g[u][l]));
            if (kJac) lb[l] = __fadd_rn(lb[l], __fmul_rn(g[u][l], z));
          }
          st4<float, kStream>(S, idx * 4, al, zero);
          st4<float, kStream>(R, idx * 4, al, r);
          st4<float, kPlain>(V, idx * 4, al, v);
          if constexpr (!std::is_same<T, float>::value)
            st4<T, kPlain>(Vs, idx * 4, al, v);
        }
      }
    }
    const int tail = (int)(n & 3);
    if (blockIdx.x == 0 && t < tail) {
      const long long e = n - tail + t;
      one(e, G[e], kJac ? D[e] : 1.f, 0);
    }
  } else {
    for (int l = 0; l < 2; ++l) {
      const long long e = gt + l * span;
      if (e < n) one(e, G[e], kJac ? D[e] : 1.f, l);
    }
  }
  constexpr int nq = kJac ? 2 : 1;
  vals[t] = sum4(la);
  if (kJac) vals[nt + t] = sum4(lb);
  cta_trees(vals, nq);
  float out[2] = {vals[0], kJac ? vals[nt] : 0.f};
  const int nb = gridDim.x;
  if (nb > 1) {
    if (t == 0) {
      part[blockIdx.x] = out[0];
      part[nb + blockIdx.x] = out[1];
      __threadfence();
      last = atomicAdd(&sc->ticket, 1u) == (unsigned)nb - 1u;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    grid_finish(part, nb, nq, vals, out);
  }
  if (t != 0) return;
  const float g2 = out[0];
  const float thr = __fmul_rn(eps, g2);
  sc->g2 = g2;
  sc->r2 = g2;
  sc->rz = kJac ? out[1] : g2;
  sc->alpha = 0.f;
  sc->beta = 0.f;
  sc->thr = thr;
  sc->it = 0;
  sc->done = !(0 < max_iter && g2 > thr);
  sc->active = 0;
  sc->ok = 0;
  sc->ticket = 0u;
  sc->bar = 0u;
}

struct StepArgs {
  const void* Hv;  // (n,) at storage dtype
  const float* D;  // (n,) or NULL without Jacobi
  float* S;
  float* R;
  float* V;
  void* Vs;        // V at storage dtype (V itself at f32)
  float* part;     // 3 ctas partial sums
  CgScalars* sc;
  long long n;
  int ctas;        // torch's virtual CTAs
  int per;         // virtual CTAs a hardware CTA carries
  int cache;       // loads of 4 per virtual thread whose V stays in smem
  int vec;         // loads of 4 (n >= 128)
  int al;          // every array aligned for 16-byte (bf16: 8-byte) access
  int max_iter;
};

// One iteration after the Hv, whole (stages 1-3 above).  Dynamic shared
// memory: per * cache * T float4 of V, then 2 * per * T floats of values.
template <typename T, bool kJac>
__global__ void __launch_bounds__(kCgMaxThreads, kCgMinBlocks)
    cg_iter_kernel(const StepArgs a) {
  CgScalars* sc = a.sc;
  // the latch, read by every CTA before the first barrier (CTA 0 writes
  // the scalars after the second), and the scalars this iteration starts
  // from
  if (*reinterpret_cast<volatile int*>(&sc->done)) return;
  const float rz0 = *reinterpret_cast<volatile float*>(&sc->rz);
  const float thr = *reinterpret_cast<volatile float*>(&sc->thr);
  const int it0 = *reinterpret_cast<volatile int*>(&sc->it);

  extern __shared__ float4 dyn[];
  const int nt = blockDim.x, t = threadIdx.x, H = gridDim.x, h = blockIdx.x;
  const int C = a.ctas, P = a.per, K = a.cache;
  float4* cache = dyn;
  float* vals = reinterpret_cast<float*>(dyn + (size_t)P * K * nt);
  const long long n = a.n, span = (long long)C * nt;
  const bool vec = a.vec, al = a.al;
  const T* __restrict__ Hv = static_cast<const T*>(a.Hv);
  const float* __restrict__ D = a.D;
  float* __restrict__ S = a.S;
  float* __restrict__ R = a.R;
  float* V = a.V;
  T* Vs = static_cast<T*>(a.Vs);
  float out[2];

  // 1. den = sum V Hv, V of the first K loads kept in shared memory
  for (int j = 0; j < P; ++j) {
    const int c = j * H + h;
    float x = 0.f, unused = 0.f;
    if (c < C) {
      thread_sums<false>(
          n, vec, (long long)c * nt + t, span, c == 0,
          [&](long long e, int k, float (&xs)[4], float (&)[4]) {
            float v[4], hv[4];
            if (k < K) {
              ld4<float, kStream>(V, e, al, v);
              cache[((size_t)j * K + k) * nt + t] =
                  make_float4(v[0], v[1], v[2], v[3]);
            } else {
              ld4<float, kPlain>(V, e, al, v);
            }
            ld4<T, kPlain>(Hv, e, al, hv);
#pragma unroll
            for (int l = 0; l < 4; ++l) xs[l] = __fmul_rn(v[l], hv[l]);
          },
          [&](long long e, float& xs, float&) {
            xs = __fmul_rn(V[e], to_f(Hv[e]));
          },
          x, unused);
    }
    vals[j * nt + t] = x;
  }
  stage_sums(vals, 1, P, C, a.part, &sc->bar, out);
  const float den = out[0];
  // the reference's degenerate-denominator guard
  const bool ok = den > 0.f;
  const float alpha = ok ? __fdiv_rn(rz0, den) : 0.f;

  // 2. S += alpha V; R -= alpha Hv; the sums of R R and (Jacobi) R (R / D)
  auto vload = [&](int j, long long e, int k, float (&v)[4]) {
    if (k < K) {
      const float4 c4 = cache[((size_t)j * K + k) * nt + t];
      v[0] = c4.x;
      v[1] = c4.y;
      v[2] = c4.z;
      v[3] = c4.w;
    } else {
      ld4<float, kPlain>(V, e, al, v);
    }
  };
  for (int j = 0; j < P; ++j) {
    const int c = j * H + h;
    float x = 0.f, y = 0.f;
    if (c < C) {
      thread_sums<kJac>(
          n, vec, (long long)c * nt + t, span, c == 0,
          [&](long long e, int k, float (&xs)[4], float (&ys)[4]) {
            float v[4], hv[4], s[4], r[4], d[4];
            vload(j, e, k, v);
            ld4<T, kStream>(Hv, e, al, hv);
            ld4<float, kStream>(S, e, al, s);
            ld4<float, kStream>(R, e, al, r);
            if (kJac) ld4<float, kPlain>(D, e, al, d);
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              s[l] = __fadd_rn(s[l], __fmul_rn(alpha, v[l]));
              r[l] = __fsub_rn(r[l], __fmul_rn(alpha, hv[l]));
              xs[l] = __fmul_rn(r[l], r[l]);
              ys[l] = kJac ? __fmul_rn(r[l], __fdiv_rn(r[l], d[l])) : 0.f;
            }
            st4<float, kStream>(S, e, al, s);
            st4<float, kPlain>(R, e, al, r);
          },
          [&](long long e, float& xs, float& ys) {
            const float s = __fadd_rn(S[e], __fmul_rn(alpha, V[e]));
            const float r = __fsub_rn(R[e], __fmul_rn(alpha, to_f(Hv[e])));
            S[e] = s;
            R[e] = r;
            xs = __fmul_rn(r, r);
            ys = kJac ? __fmul_rn(r, __fdiv_rn(r, D[e])) : 0.f;
          },
          x, y);
    }
    vals[j * nt + t] = x;
    if (kJac) vals[(P + j) * nt + t] = y;
  }
  stage_sums(vals, kJac ? 2 : 1, P, C, a.part + C, &sc->bar, out);
  const float r2 = ok ? out[0] : 0.f;
  const float rz = kJac ? out[1] : r2;
  const float beta = __fdiv_rn(rz, rz0 > 0.f ? rz0 : 1.f);
  if (h == 0 && t == 0) {
    const int it = it0 + 1;
    sc->alpha = alpha;
    sc->ok = ok;
    sc->beta = beta;
    sc->r2 = r2;
    sc->rz = rz;
    sc->it = it;
    sc->done = !(it < a.max_iter && r2 > thr);
    sc->active = 1;
  }

  // 3. V = Z + beta V with Z = R (Jacobi: R / D), and V at storage for the
  // next Hv (the same array at f32 storage)
  for (int j = 0; j < P; ++j) {
    const int c = j * H + h;
    if (c >= C) continue;
    thread_each(
        n, vec, (long long)c * nt + t, span, c == 0,
        [&](long long e, int k) {
          float v[4], r[4], d[4];
          vload(j, e, k, v);
          ld4<float, kStream>(R, e, al, r);
          if (kJac) ld4<float, kPlain>(D, e, al, d);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const float z = kJac ? __fdiv_rn(r[l], d[l]) : r[l];
            v[l] = __fadd_rn(z, __fmul_rn(beta, v[l]));
          }
          st4<float, kPlain>(V, e, al, v);
          if constexpr (!std::is_same<T, float>::value)
            st4<T, kPlain>(Vs, e, al, v);
        },
        [&](long long e) {
          const float z = kJac ? __fdiv_rn(R[e], D[e]) : R[e];
          const float v = __fadd_rn(z, __fmul_rn(beta, V[e]));
          V[e] = v;
          if constexpr (!std::is_same<T, float>::value) Vs[e] = from_f<T>(v);
        });
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int all_aligned(const void* f0, const void* f1, const void* f2,
                const void* f3, const void* f4, const void* t0,
                const void* t1) {
  const int tb = std::is_same<T, float>::value ? 16 : 8;
  return aligned(f0, 16) && aligned(f1, 16) && aligned(f2, 16) &&
         aligned(f3, 16) && aligned(f4, 16) && aligned(t0, tb) &&
         aligned(t1, tb);
}

template <typename T, bool kJac>
int launch_init(const void* G, const void* D, void* S, void* R, void* V,
                void* Vs, void* part, void* sc, long long n, int nb,
                int threads, int vec, float eps, int max_iter,
                cudaStream_t st) {
  const int al = all_aligned<T>(G, D, S, R, V, Vs, Vs);
  cg_init_kernel<T, kJac><<<nb, threads, 0, st>>>(
      (const float*)G, (const float*)D, (float*)S, (float*)R, (float*)V,
      (T*)Vs, (float*)part, (CgScalars*)sc, n, vec, al, eps, max_iter);
  return (int)cudaGetLastError();
}

// Let kernel `kern` take `smem` bytes of dynamic shared memory (only ever
// raised), then the CTAs of `threads` an SM holds with it.
template <typename K>
int kernel_blocks(K kern, int threads, int smem, int* blocks) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err == cudaSuccess && smem > fa.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                        threads, smem);
  return (int)err;
}

template <typename T, bool kJac>
int launch_step(const StepArgs& a, int grid, int threads, int smem,
                cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  // cooperative: a grid that cannot be resident at once is refused, never
  // left waiting at its barrier
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = grid > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cg_iter_kernel<T, kJac>, a);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// G, D (n,) f32 (D NULL without Jacobi); S, R, V (n,) f32 written; Vs (n,)
// at storage dtype (V itself at f32); part: 2 nb f32; sc: one CgScalars,
// its ticket 0; nb CTAs of `threads` threads, `vec`: loads of 4 (the
// launch of ops/kernels.py cg_config)
int ocffm_cg_init(int dtype, const void* G, const void* D, void* S, void* R,
                  void* V, void* Vs, void* part, void* sc, long long n,
                  int nb, int threads, int vec, float eps, int max_iter,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads < 1 || threads > kCgMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  OCFFM_BY_DTYPE(dtype, return D ? launch_init<T, true>(
      G, D, S, R, V, Vs, part, sc, n, nb, threads, vec, eps, max_iter, st)
                           : launch_init<T, false>(
      G, D, S, R, V, Vs, part, sc, n, nb, threads, vec, eps, max_iter, st));
}

// The CTAs an SM of the step kernel (`step` 1) or of cg_init_kernel (0) at
// `threads` threads and `smem` bytes of dynamic shared memory, into
// *blocks (the kernel's shared memory cap raised to `smem` first); returns
// the CUDA error.  Not for a stream capture.
int ocffm_cg_blocks(int step, int dtype, int jacobi, int threads, int smem,
                    int* blocks) {
  OCFFM_BY_DTYPE(dtype, return step
      ? (jacobi ? kernel_blocks(cg_iter_kernel<T, true>, threads, smem, blocks)
                : kernel_blocks(cg_iter_kernel<T, false>, threads, smem,
                                blocks))
      : (jacobi ? kernel_blocks(cg_init_kernel<T, true>, threads, smem, blocks)
                : kernel_blocks(cg_init_kernel<T, false>, threads, smem,
                                blocks)));
}

// one iteration after the Hv (Hv (n,) at storage dtype), one launch: the
// virtual launch (ctas CTAs of `threads`, `vec`) on `grid` hardware CTAs of
// `per` virtual CTAs each, `cache` loads of V a virtual thread kept in
// `smem` bytes of dynamic shared memory (ops/kernels.py cg_plan); part: 3
// ctas f32
int ocffm_cg_step(int dtype, const void* Hv, const void* D, void* S, void* R,
                  void* V, void* Vs, void* part, void* sc, long long n,
                  int ctas, int threads, int vec, int per, int grid,
                  int cache, int smem, int max_iter, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads < 1 || threads > kCgMaxThreads || (threads & (threads - 1)) ||
      per < 1 || grid < 1 || (long long)grid * per < ctas ||
      (long long)(grid - 1) * per >= ctas || cache < 0)
    return (int)cudaErrorInvalidValue;
  OCFFM_BY_DTYPE(dtype, {
    StepArgs a{Hv, (const float*)D, (float*)S, (float*)R, (float*)V, Vs,
               (float*)part, (CgScalars*)sc, n, ctas, per, cache, vec,
               all_aligned<T>(D, S, R, V, V, Hv, Vs), max_iter};
    return D ? launch_step<T, true>(a, grid, threads, smem, st)
             : launch_step<T, false>(a, grid, threads, smem, st);
  });
}

}  // extern "C"
