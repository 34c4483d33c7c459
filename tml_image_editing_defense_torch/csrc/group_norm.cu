// Group normalisation with the SiLU that follows it, forward and backward,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and the SiLU after
// it to XLA, which fuses them (models/layers.py).  On the H100 PyTorch runs
// them as separate passes: statistics, normalise, SiLU forward; SiLU
// backward, per-channel sums, input gradient backward.  Its statistics kernel
// also gives each (sample, group) row one block, so the 1024x1024 VAE
// decoder's 32 rows of 4 M elements keep 32 of the card's 132 SMs busy.
//
// For x of [N, C, H, W] (NCHW, contiguous), G groups, a row is one (sample,
// group): cpg = C / G channels of HW = H * W elements, contiguous in memory.
// With mean and rstd = rsqrt(var + eps) of its row (biased variance), f32:
//   a = gamma_c * (x - mean) * rstd + beta_c,   z = silu(a) or a
// and backward, with g = dz * silu'(a) (or dz), xh = (x - mean) * rstd and
// M the row's length:
//   dx = rstd * (g gamma_c - (S1 + xh S2) / M),  S1 = sum g gamma, S2 = sum g gamma xh
// gamma and beta get no gradient: the networks are frozen.
//
// What bounds it on the H100: bytes.  A few operations an element against 4
// to 6 bytes.  The design:
// - A row is cut into chunks of a whole number of 2048 elements, at least
//   8192; the wrapper (ops/group_norm.py::chunk_plan) takes as many chunks as
//   it needs for the grid of N * G * chunks blocks of 256 threads to fill the
//   card four times over, whatever the number of rows.  Grid index = row *
//   chunks + chunk.
// - Forward: (1) per chunk, Welford moments (mean, M2) in f32: each thread
//   takes the two-pass moments of each 16-byte vector it loads (eight bf16 or
//   four f32 elements) and merges them into its own by Chan's formula, then a
//   fixed tree over the block; one partial per chunk in a scratch buffer.
//   (2) every block merges its row's partials in a fixed order (Chan), writes
//   z, and the first chunk's block writes the row's (mean, rstd) for the
//   backward.
// - Rounding: in bf16 the kernels round where PyTorch's unfused ops round:
//   the row's mean and rstd (PyTorch keeps them in the input's dtype), a
//   before the SiLU, and the SiLU's gradient dy before the norm's backward;
//   the rest in f32.  Statistics kept in f32 and one rounding are closer to
//   a float32 witness, but the benchmark holds the program to a plain bf16
//   reference that rounds at those points, and without them its loss gap at
//   1024x1024 passed the benchmark's limit on one seed in 21.
// - Backward: (1) per chunk, the sums of g gamma and g gamma xh, with a and
//   silu'(a) recomputed from x, mean and rstd (the forward's output is not
//   kept); (2) every block sums its row's partials in a fixed order and
//   writes dx.
// - Deterministic: no atomics, and every sum in one fixed order, so two runs
//   (and a CUDA graph's replay against the eager call) give the same bits.
// - Each thread loads kUnroll vectors before it uses any, 16-byte loads and
//   stores; where HW is no multiple of the vector width or a pointer is off a
//   16-byte boundary, a scalar path over the same chunks.
// - Nothing is allocated here and nothing waits on the host: the wrapper
//   passes the scratch, so a CUDA graph can capture the calls.
// Kernel names hold "norm" and none of the convolution or matmul names, so
// that a profile files their time under group norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct F32Elem {
  using Bits = float;
  static __device__ __forceinline__ float load(Bits v) { return v; }
  static __device__ __forceinline__ Bits store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

struct BF16Elem {
  using Bits = unsigned short;
  static __device__ __forceinline__ float load(Bits v) { return __uint_as_float((unsigned)v << 16); }
  static __device__ __forceinline__ Bits store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));      // round to nearest even
  }
  static __device__ __forceinline__ float round(float v) { return load(store(v)); }
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // 16-byte vectors a thread loads before it uses them
constexpr unsigned kFull = 0xffffffffu;

// Count, mean and M2 (the sum of squared deviations) of a set of elements.
struct Moments {
  float n, mean, m2;
};

// Chan's merge of two sets' moments; an empty set leaves the other as it is.
__device__ __forceinline__ Moments chan(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float d = b.mean - a.mean;
  return {n, fmaf(d, wb, a.mean), a.m2 + b.m2 + d * d * a.n * wb};
}

// The warp's moments in lane 0, by a fixed tree (lanes past the tree's reach
// merge garbage that no lane below reads).
__device__ __forceinline__ Moments warp_chan(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o = {__shfl_down_sync(kFull, m.n, off), __shfl_down_sync(kFull, m.mean, off),
                       __shfl_down_sync(kFull, m.m2, off)};
    m = chan(m, o);
  }
  return m;
}

// The block's moments in thread 0: each warp's, then the warps' in order.
__device__ __forceinline__ Moments block_chan(Moments m, Moments* red) {
  m = warp_chan(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = chan(m, red[w]);
  }
  return m;
}

// Sums of two values over the warp in lane 0, by a fixed tree.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(kFull, a, off);
    b += __shfl_down_sync(kFull, b, off);
  }
}

// The rows' scalars: mean and rstd, or the backward's S1 / M and S2 / M.
// The first warp merges the row's chunk partials (lane l takes chunks l,
// l + 32, ... in order, then a fixed tree) and leaves them in `out`.
__device__ __forceinline__ void row_moments(const float* part, int row_len, int chunk, int chunks,
                                            float eps, float* out) {
  if (threadIdx.x < 32) {
    Moments m = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < chunks; i += 32)
      m = chan(m, {(float)min(chunk, row_len - i * chunk), part[2 * i], part[2 * i + 1]});
    m = warp_chan(m);
    if (threadIdx.x == 0) {
      out[0] = m.mean;
      out[1] = rsqrtf(m.m2 / m.n + eps);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void row_sums(const float* part, int row_len, int chunks, float* out) {
  if (threadIdx.x < 32) {
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < chunks; i += 32) {
      a += part[2 * i];
      b += part[2 * i + 1];
    }
    warp_sum2(a, b);
    if (threadIdx.x == 0) {
      out[0] = a / (float)row_len;
      out[1] = b / (float)row_len;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float a) { return __frcp_rn(1.f + __expf(-a)); }

// The block's share of one row: elements [start, end) of NIN inputs (each
// pointing at the row's first element).  Vectorized: thread t takes the
// 16-byte vectors at start + (t + k * kThreads) * V, kUnroll of them loaded
// before any is used; else one element at a time.  body(p, f, n) gets the
// offset p in the row of the first of n (V or 1) elements and their values
// in f32, f[input][element].
template <typename E, int NIN, typename Body>
__device__ __forceinline__ void for_each(const typename E::Bits* const (&in)[NIN], int start,
                                         int end, int vectorized, Body&& body) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack { uint4 u; Bits e[V]; };
  if (vectorized) {
    for (int p0 = start + threadIdx.x * V; p0 < end; p0 += kThreads * V * kUnroll) {
      Pack v[kUnroll][NIN];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads * V;
        if (p < end) {
#pragma unroll
          for (int i = 0; i < NIN; ++i) v[u][i].u = *reinterpret_cast<const uint4*>(in[i] + p);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kThreads * V;
        if (p < end) {
          float f[NIN][V];
#pragma unroll
          for (int i = 0; i < NIN; ++i)
#pragma unroll
            for (int k = 0; k < V; ++k) f[i][k] = E::load(v[u][i].e[k]);
          body(p, f, V);
        }
      }
    }
  } else {
    for (int p = start + threadIdx.x; p < end; p += kThreads) {
      float f[NIN][V] = {};
#pragma unroll
      for (int i = 0; i < NIN; ++i) f[i][0] = E::load(in[i][p]);
      body(p, f, 1);
    }
  }
}

// n (V or 1) values to dst, as one 16-byte vector or one element.
template <typename E, int V>
__device__ __forceinline__ void store_n(typename E::Bits* dst, const float (&v)[V], int n) {
  using Bits = typename E::Bits;
  if (n == V) {
    union Pack { uint4 u; Bits e[V]; } o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.e[k] = E::store(v[k]);
    *reinterpret_cast<uint4*>(dst) = o.u;
  } else {
    dst[0] = E::store(v[0]);
  }
}

// The affine map of channel ch: a = x * scale + shift, as PyTorch fuses it.
template <typename E>
__device__ __forceinline__ void affine(const typename E::Bits* gamma, const typename E::Bits* beta,
                                       int ch, float mean, float rstd, float& gam, float& scale,
                                       float& shift) {
  gam = E::load(gamma[ch]);
  scale = gam * rstd;
  shift = fmaf(-mean, scale, E::load(beta[ch]));
}

// g gamma of one element: the gradient reaching the normalised value, with
// the SiLU's gradient at y = a in x's dtype, rounded to it (PyTorch's dy).
template <typename E, bool SILU>
__device__ __forceinline__ float grad_at(float x, float dz, float gam, float scale, float shift) {
  if constexpr (SILU) {
    const float y = E::round(fmaf(x, scale, shift));
    const float s = sigmoid(y);
    dz = E::round(dz * (s * fmaf(y, 1.f - s, 1.f)));
  }
  return dz * gam;
}

// ---- forward ------------------------------------------------------------------

template <typename E>
__global__ void __launch_bounds__(kThreads)
group_norm_moments_kernel(const typename E::Bits* __restrict__ x, float* __restrict__ partials,
                          int row_len, int chunk, int chunks, int vectorized) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  __shared__ Moments red[kWarps];
  const long long row = blockIdx.x / chunks;
  const int start = (int)(blockIdx.x - row * chunks) * chunk;
  const int end = min(start + chunk, row_len);
  const Bits* in[1] = {x + row * row_len};
  Moments m = {0.f, 0.f, 0.f};
  for_each<E, 1>(in, start, end, vectorized, [&](int, const float (&f)[1][V], int n) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += f[0][k];
    const float mu = n == V ? s * (1.f / V) : s;
    float q = 0.f;
    for (int k = 0; k < n; ++k) {
      const float d = f[0][k] - mu;
      q = fmaf(d, d, q);
    }
    m = chan(m, {(float)n, mu, q});
  });
  m = block_chan(m, red);
  if (threadIdx.x == 0) {
    partials[2 * (long long)blockIdx.x] = m.mean;
    partials[2 * (long long)blockIdx.x + 1] = m.m2;
  }
}

template <typename E, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_apply_kernel(const typename E::Bits* __restrict__ x,
                        const typename E::Bits* __restrict__ gamma,
                        const typename E::Bits* __restrict__ beta,
                        const float* __restrict__ partials, float* __restrict__ stats,
                        typename E::Bits* __restrict__ out, int row_len, int hw, int groups,
                        int cpg, int chunk, int chunks, float eps, int vectorized) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  __shared__ float rs[2];
  const long long row = blockIdx.x / chunks;
  const int c = (int)(blockIdx.x - row * chunks);
  row_moments(partials + 2 * row * chunks, row_len, chunk, chunks, eps, rs);
  const float mean = E::round(rs[0]), rstd = E::round(rs[1]);   // as PyTorch stores them
  if (c == 0 && threadIdx.x == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
  const int ch0 = (int)(row % groups) * cpg;
  const Bits* in[1] = {x + row * row_len};
  Bits* o = out + row * row_len;
  const int start = c * chunk;
  for_each<E, 1>(in, start, min(start + chunk, row_len), vectorized,
                 [&](int p, const float (&f)[1][V], int n) {
    float gam, scale, shift;
    affine<E>(gamma, beta, ch0 + (int)((unsigned)p / (unsigned)hw), mean, rstd, gam, scale, shift);
    float z[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float a = fmaf(f[0][k], scale, shift);
      if constexpr (SILU) {
        const float y = E::round(a);           // the norm's output, as PyTorch stores it
        z[k] = y * sigmoid(y);
      } else {
        z[k] = a;
      }
    }
    store_n<E, V>(o + p, z, n);
  });
}

// ---- backward -----------------------------------------------------------------

template <typename E, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_grad_sums_kernel(const typename E::Bits* __restrict__ x,
                            const typename E::Bits* __restrict__ dz,
                            const typename E::Bits* __restrict__ gamma,
                            const typename E::Bits* __restrict__ beta,
                            const float* __restrict__ stats, float* __restrict__ partials,
                            int row_len, int hw, int groups, int cpg, int chunk, int chunks,
                            int vectorized) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  __shared__ float red[kWarps][2];
  const long long row = blockIdx.x / chunks;
  const int start = (int)(blockIdx.x - row * chunks) * chunk;
  const float mean = stats[2 * row], rstd = stats[2 * row + 1];
  const int ch0 = (int)(row % groups) * cpg;
  const Bits* in[2] = {x + row * row_len, dz + row * row_len};
  float s1 = 0.f, s2 = 0.f;
  for_each<E, 2>(in, start, min(start + chunk, row_len), vectorized,
                 [&](int p, const float (&f)[2][V], int n) {
    float gam, scale, shift;
    affine<E>(gamma, beta, ch0 + (int)((unsigned)p / (unsigned)hw), mean, rstd, gam, scale, shift);
    for (int k = 0; k < n; ++k) {
      const float gg = grad_at<E, SILU>(f[0][k], f[1][k], gam, scale, shift);
      s1 += gg;
      s2 = fmaf(gg, (f[0][k] - mean) * rstd, s2);
    }
  });
  warp_sum2(s1, s2);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = s1;
    red[threadIdx.x >> 5][1] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      red[0][0] += red[w][0];
      red[0][1] += red[w][1];
    }
    partials[2 * (long long)blockIdx.x] = red[0][0];
    partials[2 * (long long)blockIdx.x + 1] = red[0][1];
  }
}

template <typename E, bool SILU>
__global__ void __launch_bounds__(kThreads)
group_norm_grad_input_kernel(const typename E::Bits* __restrict__ x,
                             const typename E::Bits* __restrict__ dz,
                             const typename E::Bits* __restrict__ gamma,
                             const typename E::Bits* __restrict__ beta,
                             const float* __restrict__ stats, const float* __restrict__ partials,
                             typename E::Bits* __restrict__ dx, int row_len, int hw, int groups,
                             int cpg, int chunk, int chunks, int vectorized) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  __shared__ float rs[2];
  const long long row = blockIdx.x / chunks;
  const int start = (int)(blockIdx.x - row * chunks) * chunk;
  row_sums(partials + 2 * row * chunks, row_len, chunks, rs);
  const float c1 = rs[0], c2 = rs[1];
  const float mean = stats[2 * row], rstd = stats[2 * row + 1];
  const int ch0 = (int)(row % groups) * cpg;
  const Bits* in[2] = {x + row * row_len, dz + row * row_len};
  Bits* o = dx + row * row_len;
  for_each<E, 2>(in, start, min(start + chunk, row_len), vectorized,
                 [&](int p, const float (&f)[2][V], int n) {
    float gam, scale, shift;
    affine<E>(gamma, beta, ch0 + (int)((unsigned)p / (unsigned)hw), mean, rstd, gam, scale, shift);
    float d[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float gg = grad_at<E, SILU>(f[0][k], f[1][k], gam, scale, shift);
      d[k] = rstd * (gg - fmaf((f[0][k] - mean) * rstd, c2, c1));
    }
    store_n<E, V>(o + p, d, n);
  });
}

// ---- launches -----------------------------------------------------------------

bool aligned16(const void* a, const void* b, const void* c = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

template <typename E>
cudaError_t forward(const void* x, const void* gamma, const void* beta, float* partials,
                    float* stats, void* out, long long rows, int row_len, int hw, int groups,
                    int cpg, int chunk, int chunks, int silu, float eps, cudaStream_t s) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const int vec = aligned16(x, out) && hw % V == 0;
  const unsigned blocks = (unsigned)(rows * chunks);
  const Bits *xb = (const Bits*)x, *gb = (const Bits*)gamma, *bb = (const Bits*)beta;
  group_norm_moments_kernel<E><<<blocks, kThreads, 0, s>>>(xb, partials, row_len, chunk, chunks,
                                                           vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    group_norm_apply_kernel<E, true><<<blocks, kThreads, 0, s>>>(
        xb, gb, bb, partials, stats, (Bits*)out, row_len, hw, groups, cpg, chunk, chunks, eps, vec);
  else
    group_norm_apply_kernel<E, false><<<blocks, kThreads, 0, s>>>(
        xb, gb, bb, partials, stats, (Bits*)out, row_len, hw, groups, cpg, chunk, chunks, eps, vec);
  return cudaGetLastError();
}

template <typename E, bool SILU>
cudaError_t backward(const void* x, const void* dz, const void* gamma, const void* beta,
                     const float* stats, float* partials, void* dx, long long rows, int row_len,
                     int hw, int groups, int cpg, int chunk, int chunks, cudaStream_t s) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const int vec = aligned16(x, dz, dx) && hw % V == 0;
  const unsigned blocks = (unsigned)(rows * chunks);
  const Bits *xb = (const Bits*)x, *db = (const Bits*)dz, *gb = (const Bits*)gamma,
             *bb = (const Bits*)beta;
  group_norm_grad_sums_kernel<E, SILU><<<blocks, kThreads, 0, s>>>(
      xb, db, gb, bb, stats, partials, row_len, hw, groups, cpg, chunk, chunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_norm_grad_input_kernel<E, SILU><<<blocks, kThreads, 0, s>>>(
      xb, db, gb, bb, stats, partials, (Bits*)dx, row_len, hw, groups, cpg, chunk, chunks, vec);
  return cudaGetLastError();
}

}  // namespace

// Forward: z and the rows' (mean, rstd) ([rows, 2] f32) from x, gamma, beta
// (all of x's dtype).  `partials` is the wrapper's scratch of rows * chunks *
// 2 floats; a row is one (sample, group) of row_len = cpg * hw elements,
// cut into `chunks` chunks of `chunk` elements (a multiple of 2048; the last
// one ragged).
extern "C" int tid_group_norm_fwd(const void* x, const void* gamma, const void* beta,
                                  void* partials, void* stats, void* out, long long rows,
                                  int row_len, int hw, int groups, int cpg, int chunk, int chunks,
                                  int is_bf16, int silu, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)forward<BF16Elem>(x, gamma, beta, (float*)partials, (float*)stats, out, rows,
                                  row_len, hw, groups, cpg, chunk, chunks, silu, eps, s);
  return (int)forward<F32Elem>(x, gamma, beta, (float*)partials, (float*)stats, out, rows, row_len,
                               hw, groups, cpg, chunk, chunks, silu, eps, s);
}

// Backward: dx from dz, x, gamma, beta and the forward's (mean, rstd); the
// same chunks and scratch size as the forward.
extern "C" int tid_group_norm_bwd(const void* x, const void* dz, const void* gamma,
                                  const void* beta, const void* stats, void* partials, void* dx,
                                  long long rows, int row_len, int hw, int groups, int cpg,
                                  int chunk, int chunks, int is_bf16, int silu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* st = (const float*)stats;
  float* pa = (float*)partials;
  if (is_bf16)
    return silu ? (int)backward<BF16Elem, true>(x, dz, gamma, beta, st, pa, dx, rows, row_len, hw,
                                                groups, cpg, chunk, chunks, s)
                : (int)backward<BF16Elem, false>(x, dz, gamma, beta, st, pa, dx, rows, row_len,
                                                 hw, groups, cpg, chunk, chunks, s);
  return silu ? (int)backward<F32Elem, true>(x, dz, gamma, beta, st, pa, dx, rows, row_len, hw,
                                             groups, cpg, chunk, chunks, s)
              : (int)backward<F32Elem, false>(x, dz, gamma, beta, st, pa, dx, rows, row_len, hw,
                                              groups, cpg, chunk, chunks, s);
}
