// Hopper (sm_90a) kernel K2: the recurrence of a Newton solve's conjugate
// gradient, after each Hv, with the stop rule on the card.  Built with the
// other sources into one shared library (ops/kernels.py), bound with ctypes.
//
// Replaces the body and the cond of the reference's CG while_loop
// (one_class_ffm_tpu/solver/jax_solver.py FFMSolver._cg: jax.lax.while_loop
// over cond / body; the start, S0, V0, g2 and rz0, is cg_init_kernel).
// There XLA fuses the recurrence into the loop's program and the stop test
// never leaves the device; the port's eager loop ran ~15 torch operations
// per iteration and read the test on the host.  Here one iteration after
// the Hv is three launches over the solve's vectors (f32, the recurrence's
// floor, as the reference's):
//   cg_dot_kernel     den = sum V Hv; alpha = rz / den where den > 0, else 0
//   cg_update_kernel  S += alpha V; R -= alpha Hv; Z = R / D (Jacobi);
//                     r2 = sum R R (0 where den <= 0), rz = sum R Z (or r2);
//                     beta = rz / (old rz > 0 ? old rz : 1); it += 1;
//                     done = !(it < cg_max_iter && r2 > cg_eps g2)
//   cg_dir_kernel     V = Z + beta V, and V rounded to storage for the Hv
// Every scalar (g2, r2, rz, alpha, beta, the threshold, the count, the done
// flag) lives in one CgScalars block per solve on the card; the host reads
// only the count and the flag, once per group of iterations.  An iteration
// entered while done is set writes nothing: cg_dot_kernel latches the flag
// into `active` at the iteration's start, and the other two read that.
//
// Sums: in the order of torch's CUDA sum of a contiguous float32 tensor
// into one output (ATen/native/cuda/Reduce.cuh), so that the loop on the
// card gives the bits of the eager torch loop it replaced.  The launch is
// Reduce.cuh's (ops/kernels.py cg_config): a row of `threads` threads (a
// power of two, at most 512) in `ctas` CTAs; from n = 128 each thread adds
// its grid-strided loads of 4 elements in 4 accumulators, lane by lane,
// the first n % 4 threads of CTA 0 add the tail into the first, and
// ((a0 + a1) + a2) + a3 is the thread's value; below 128 each thread adds
// its elements t and t + threads.  A CTA halves its values through shared
// memory down to one warp, and the warp's shuffles down at offsets 16 ..
// 1 finish; past one CTA, the CTA that takes the last ticket (an integer
// counter, reset to 0 by that CTA) has thread t add the partials t, t +
// threads, ... from 0 and halves those the same way.  Each element's
// updates run in the thread that adds its terms.  Products and sums are
// rounded one at a time (__fmul_rn / __fadd_rn, no fused multiply-add),
// the divisions by __fdiv_rn, as torch's eager operations round;
// sparse_ops.cg_init_plain and cg_step_plain sum with torch's own sum and
// agree with these kernels bit for bit on the card.
// No float atomics: two runs give the same bits.
//
// Bound on the H100: bytes.  Per iteration the recurrence reads S, R, V,
// Hv (and D) and writes S, R, V (and V at storage), a handful of flops per
// element: far below the 20 flops per byte where f32 arithmetic would bind.

#include "common.cuh"

using namespace ocffm;

namespace {

constexpr int kCgMaxThreads = 512;  // Reduce.cuh's widest CTA
constexpr int kDirThreads = 256;

// a solve's scalars, one block on the card (ops/kernels.py CG_WORDS words
// of 4 bytes; the host reads `it` and `done`)
struct CgScalars {
  float g2, r2, rz, alpha, beta, thr;
  int it, done, active, ok;
  unsigned ticket;  // 0 between launches
  int unused[5];
};
static_assert(sizeof(CgScalars) == 64, "CgScalars is 16 words");

// Reduce.cuh's block_x_reduce of one value per thread: halving through
// shared memory down to a warp, then shuffles down at offsets 16 .. 1.
// The sum is thread 0's; every thread must call it.
__device__ __forceinline__ float cta_sum(float v, float* sh) {
  const int t = threadIdx.x;
  int width = blockDim.x;
  if (width > 32) {
    sh[t] = v;
    for (int off = width / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (t < off) {
        v = __fadd_rn(v, sh[t + off]);
        sh[t] = v;
      }
    }
    width = 32;
  }
  __syncthreads();
  if (t < 32) {
    const unsigned mask = width >= 32 ? 0xffffffffu : (1u << width) - 1u;
    for (int off = width >> 1; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(mask, v, off));
  }
  __syncthreads();
  return v;
}

// Reduce.cuh's thread_reduce of one sum (two with kTwo) over the elements
// i in [0, n): f(i, x, y) runs element i's updates and gives its terms.
template <bool kTwo, typename F>
__device__ __forceinline__ void thread_sums(long long n, bool vec, F f,
                                            float& a, float& b) {
  float la[4] = {0.f, 0.f, 0.f, 0.f}, lb[4] = {0.f, 0.f, 0.f, 0.f};
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long span = (long long)gridDim.x * blockDim.x;
  float x = 0.f, y = 0.f;
  if (vec) {
    for (long long idx = t; idx * 4 + 3 < n; idx += span) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        f(idx * 4 + l, x, y);
        la[l] = __fadd_rn(la[l], x);
        if (kTwo) lb[l] = __fadd_rn(lb[l], y);
      }
    }
    const int tail = (int)(n & 3);
    if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
      f(n - tail + threadIdx.x, x, y);
      la[0] = __fadd_rn(la[0], x);
      if (kTwo) lb[0] = __fadd_rn(lb[0], y);
    }
  } else {
    for (int l = 0; l < 2; ++l) {
      const long long i = t + l * span;
      if (i < n) {
        f(i, x, y);
        la[l] = __fadd_rn(la[l], x);
        if (kTwo) lb[l] = __fadd_rn(lb[l], y);
      }
    }
  }
  a = __fadd_rn(__fadd_rn(__fadd_rn(la[0], la[1]), la[2]), la[3]);
  if (kTwo) b = __fadd_rn(__fadd_rn(__fadd_rn(lb[0], lb[1]), lb[2]), lb[3]);
}

// After thread 0 wrote the CTA's partials: true in every thread of the CTA
// that took the last ticket, which then sees every CTA's partials.
__device__ __forceinline__ bool last_cta(CgScalars* sc) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&sc->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// the sum of the grid's partials part[0 .. nb) in the last CTA: thread t
// adds t, t + threads, ... from 0, then cta_sum (thread 0's)
__device__ __forceinline__ float grid_sum(const float* part, int nb,
                                          float* sh) {
  float v = 0.f;
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    v = __fadd_rn(v, __ldcg(part + i));
  return cta_sum(v, sh);
}

// One or two sums of the whole grid, in thread 0 of the CTA that finishes
// (the only CTA, or the one with the last ticket): false elsewhere.
template <bool kTwo>
__device__ __forceinline__ bool finish_sums(float& a, float& b, float* part,
                                            CgScalars* sc, float* sh) {
  a = cta_sum(a, sh);
  if (kTwo) b = cta_sum(b, sh);
  const int nb = gridDim.x;
  if (nb > 1) {
    if (threadIdx.x == 0) {
      part[blockIdx.x] = a;
      part[nb + blockIdx.x] = b;
    }
    if (!last_cta(sc)) return false;
    a = grid_sum(part, nb, sh);
    if (kTwo) b = grid_sum(part + nb, nb, sh);
  }
  return threadIdx.x == 0;
}

// The start: S = 0, R = -G, V = -G (Jacobi: -G / D) and V at storage;
// g2 = sum G G, rz = g2 (Jacobi: sum G (G / D)), r2 = g2, thr = eps g2,
// it = 0, done = !(0 < max_iter && g2 > thr).
template <typename T, bool kJac>
__global__ void __launch_bounds__(kCgMaxThreads) cg_init_kernel(
    const float* __restrict__ G, const float* __restrict__ D,
    float* __restrict__ S, float* __restrict__ R, float* V, T* Vs,
    float* __restrict__ part, CgScalars* sc, long long n, int vec,
    float eps, int max_iter) {
  __shared__ float sh[kCgMaxThreads];
  float a = 0.f, b = 0.f;
  thread_sums<kJac>(n, vec, [&](long long i, float& x, float& y) {
    const float g = G[i];
    const float z = kJac ? __fdiv_rn(g, D[i]) : g;
    S[i] = 0.f;
    R[i] = -g;
    V[i] = -z;
    Vs[i] = from_f<T>(-z);
    x = __fmul_rn(g, g);
    y = __fmul_rn(g, z);
  }, a, b);
  if (!finish_sums<kJac>(a, b, part, sc, sh)) return;
  const float g2 = a;
  const float thr = __fmul_rn(eps, g2);
  sc->g2 = g2;
  sc->r2 = g2;
  sc->rz = kJac ? b : g2;
  sc->alpha = 0.f;
  sc->beta = 0.f;
  sc->thr = thr;
  sc->it = 0;
  sc->done = !(0 < max_iter && g2 > thr);
  sc->active = 0;
  sc->ok = 0;
  sc->ticket = 0u;
}

// den = sum V Hv; alpha = rz / den where den > 0, else 0 (the reference's
// degenerate-denominator guard).  Latches `active` = !done for the
// iteration; a stopped solve's launch writes nothing else.
template <typename T>
__global__ void __launch_bounds__(kCgMaxThreads) cg_dot_kernel(
    const float* __restrict__ V, const T* __restrict__ Hv,
    float* __restrict__ part, CgScalars* sc, long long n, int vec) {
  __shared__ float sh[kCgMaxThreads];
  if (sc->done) {
    if (blockIdx.x == 0 && threadIdx.x == 0) sc->active = 0;
    return;
  }
  float a = 0.f, b = 0.f;
  thread_sums<false>(n, vec, [&](long long i, float& x, float& y) {
    x = __fmul_rn(V[i], to_f(Hv[i]));
  }, a, b);
  if (!finish_sums<false>(a, b, part, sc, sh)) return;
  const float den = a;
  const bool ok = den > 0.f;
  sc->ok = ok;
  sc->alpha = ok ? __fdiv_rn(sc->rz, den) : 0.f;
  sc->active = 1;
  sc->ticket = 0u;
}

// S += alpha V; R -= alpha Hv; the sums of R R and (Jacobi) R (R / D); the
// scalars of the next iteration and the done flag.
template <typename T, bool kJac>
__global__ void __launch_bounds__(kCgMaxThreads) cg_update_kernel(
    float* __restrict__ S, float* __restrict__ R, const float* __restrict__ V,
    const T* __restrict__ Hv, const float* __restrict__ D,
    float* __restrict__ part, CgScalars* sc, long long n, int vec,
    int max_iter) {
  __shared__ float sh[kCgMaxThreads];
  if (!sc->active) return;
  const float alpha = sc->alpha;
  float a = 0.f, b = 0.f;
  thread_sums<kJac>(n, vec, [&](long long i, float& x, float& y) {
    const float s = __fadd_rn(S[i], __fmul_rn(alpha, V[i]));
    const float r = __fsub_rn(R[i], __fmul_rn(alpha, to_f(Hv[i])));
    S[i] = s;
    R[i] = r;
    x = __fmul_rn(r, r);
    y = kJac ? __fmul_rn(r, __fdiv_rn(r, D[i])) : 0.f;
  }, a, b);
  if (!finish_sums<kJac>(a, b, part, sc, sh)) return;
  const float r2 = sc->ok ? a : 0.f;
  const float rz_new = kJac ? b : r2;
  const float rz = sc->rz;
  const int it = sc->it + 1;
  sc->beta = __fdiv_rn(rz_new, rz > 0.f ? rz : 1.f);
  sc->r2 = r2;
  sc->rz = rz_new;
  sc->it = it;
  sc->done = !(it < max_iter && r2 > sc->thr);
  sc->ticket = 0u;
}

// V = Z + beta V with Z = R (Jacobi: R / D), and V at storage for the next
// Hv (the same array at f32 storage)
template <typename T, bool kJac>
__global__ void __launch_bounds__(kDirThreads) cg_dir_kernel(
    const float* __restrict__ R, const float* __restrict__ D, float* V,
    T* Vs, const CgScalars* sc, long long n) {
  if (!sc->active) return;
  const float beta = sc->beta;
  for (long long i = (long long)blockIdx.x * kDirThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kDirThreads) {
    const float z = kJac ? __fdiv_rn(R[i], D[i]) : R[i];
    const float v = __fadd_rn(z, __fmul_rn(beta, V[i]));
    V[i] = v;
    Vs[i] = from_f<T>(v);
  }
}

int dir_ctas(long long n) {
  const long long c = (n + kDirThreads - 1) / kDirThreads;
  return (int)(c < 1024 ? (c > 0 ? c : 1) : 1024);
}

template <typename T, bool kJac>
int launch_init(const void* G, const void* D, void* S, void* R, void* V,
                void* Vs, void* part, void* sc, long long n, int nb,
                int threads, int vec, float eps, int max_iter,
                cudaStream_t st) {
  cg_init_kernel<T, kJac><<<nb, threads, 0, st>>>(
      (const float*)G, (const float*)D, (float*)S, (float*)R, (float*)V,
      (T*)Vs, (float*)part, (CgScalars*)sc, n, vec, eps, max_iter);
  return (int)cudaGetLastError();
}

template <typename T, bool kJac>
int launch_step(const void* Hv, const void* D, void* S, void* R, void* V,
                void* Vs, void* part, void* sc, long long n, int nb,
                int threads, int vec, int max_iter, cudaStream_t st) {
  cg_dot_kernel<T><<<nb, threads, 0, st>>>(
      (const float*)V, (const T*)Hv, (float*)part, (CgScalars*)sc, n, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cg_update_kernel<T, kJac><<<nb, threads, 0, st>>>(
      (float*)S, (float*)R, (const float*)V, (const T*)Hv, (const float*)D,
      (float*)part, (CgScalars*)sc, n, vec, max_iter);
  err = (int)cudaGetLastError();
  if (err) return err;
  cg_dir_kernel<T, kJac><<<dir_ctas(n), kDirThreads, 0, st>>>(
      (const float*)R, (const float*)D, (float*)V, (T*)Vs,
      (const CgScalars*)sc, n);
  return (int)cudaGetLastError();
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

// one iteration after the Hv (Hv (n,) at storage dtype): three launches
int ocffm_cg_step(int dtype, const void* Hv, const void* D, void* S, void* R,
                  void* V, void* Vs, void* part, void* sc, long long n,
                  int nb, int threads, int vec, int max_iter, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads < 1 || threads > kCgMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  OCFFM_BY_DTYPE(dtype, return D ? launch_step<T, true>(
      Hv, D, S, R, V, Vs, part, sc, n, nb, threads, vec, max_iter, st)
                           : launch_step<T, false>(
      Hv, D, S, R, V, Vs, part, sc, n, nb, threads, vec, max_iter, st));
}

}  // extern "C"
