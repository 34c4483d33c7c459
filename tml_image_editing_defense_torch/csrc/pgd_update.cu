// Fused PGD perturbation updates for Hopper (sm_90a): L2 (K4) and L-inf (K5).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Element types of both updates: the bits in memory, and f32 arithmetic.
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

// min and max that propagate NaN, as torch.minimum, torch.maximum and
// torch.clamp do (fminf/fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// ---- K4, the L2 update ------------------------------------------------------
//
// Replaces: tml_image_editing_defense_tpu/ops/pgd_kernels.py
//   _l2_kernel and _l2_masked_kernel (the pallas_calls in pgd_l2_update).
// Per sample b, in f32, result cast back to the input dtype:
//   gden = ||grad|| + 1e-10
//   gn   = grad / gden, times mask[b, 0, y, x] when a mask is given
//   d    = (x_adv - gn * step) - src
//   d   <- d * eps / (||d|| + 1e-7)  when ||d|| > eps
//   out  = clip(src + d, min, max)
// which is attack/pgd.py::l2_perturbation_step with per-sample norms (the
// Pallas kernel takes batch 1 only).
//
// What bounds it on the H100: bytes.  It does ~15 operations per element
// and must read x, grad and src (and the mask) and write the output once:
// 12.6 MB at [1, 3, 512, 512] f32, 3.8 us at 3.35 TB/s.  The two norms
// depend on each other (||d|| needs the normalised gradient); the Pallas
// kernel holds the image in VMEM and reduces twice.  Here:
// - The work is cut into fixed chunks: (sample b, 256 x 4 pixels in f32,
//   256 x 8 in bf16, every channel).  B * H * W / chunk blocks spread over
//   all SMs (256 blocks at [1, 3, 512, 512] f32); each thread takes one
//   16-byte vector of each plane, the mask's vector once for all channels.
//   A size that is no multiple of the vector width, or a pointer off a
//   16-byte boundary, takes a scalar path over the same chunks.
// - One cross-block reduction instead of two dependent ones.  With
//   a = x - src, h = grad * mask (mask 1 when none) and c = step / gden,
//     ||d||^2 = sum a^2 - 2 c sum a h + c^2 sum h^2,  gden = sqrt(sum g^2) + 1e-10,
//   so one pass gives the four moments both norms need.  Each chunk writes
//   its four f32 partial sums to a [B, chunks, 4] scratch buffer.
// - Every block then sums its sample's partials in a fixed order, in f64
//   (so the result does not depend on the grid and is the same bits in
//   every call: no float atomics), forms gden and the factor (||d||^2
//   clamped at 0) and writes its chunk.
// - Where the whole grid fits on the card at once (the vector path, at
//   most four channels, [1, 3, 512, 512] on an H100), that is one
//   cooperative kernel: each thread keeps its vectors in registers across
//   a grid barrier, so the operands are read once.  Elsewhere ([8, 3, 512,
//   512], the scalar path) two kernels: the partials, then a write kernel
//   that re-reads its chunk (from L2 when the operands fit in its 50 MB),
//   launched with programmatic dependent launch so that it waits on the
//   first grid (griddepcontrol.wait) and its launch overlaps that grid's
//   tail.  On an H100 the one kernel took 10-15 % less time than the two
//   at [1, 3, 512, 512], warm and cold (scripts/probe_pgd_cuda.py).
// The f32 moments are accurate enough: where the branch is decided,
// ||d|| ~ eps, each term is at most (eps + step)^2, so their sum's relative
// error (~1e-6) moves the factor by ~1e-6 and an output by far less than
// 1e-5.  Terms much larger than ||d||^2 -- an iterate far outside the
// ball, stepping back towards it -- would lose digits to cancellation.

constexpr int kL2Threads = 256;
constexpr int kL2ResidentC = 4;      // channels a thread of the one-kernel path holds

// Sum over the block of K values a thread; every thread gets the totals, the
// same bits in every thread (each butterfly step adds a pair both partners
// hold).  `red` holds K * 32 values.
template <int K, typename T>
__device__ __forceinline__ void block_sum(T (&v)[K], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (lane == 0) red[k * 32 + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = lane < kL2Threads / 32 ? red[k * 32 + lane] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
}

// acc: sum g^2, sum a^2, sum a h, sum h^2 (the last only with a mask: h = g).
template <bool MASK>
__device__ __forceinline__ void l2_moments(float x, float g, float s, float m, float (&acc)[4]) {
  const float a = x - s;
  const float h = MASK ? g * m : g;
  acc[0] = fmaf(g, g, acc[0]);
  acc[1] = fmaf(a, a, acc[1]);
  acc[2] = fmaf(a, h, acc[2]);
  if constexpr (MASK) acc[3] = fmaf(h, h, acc[3]);
}

// The block's moments summed, written as its chunk's row of the partials.
template <bool MASK>
__device__ __forceinline__ void store_partials(float (&acc)[4], float* red, float4* partials) {
  block_sum<4>(acc, red);
  if (threadIdx.x == 0)
    partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] =
        make_float4(acc[0], acc[1], acc[2], MASK ? acc[3] : acc[0]);
}

// gden and the factor of sample blockIdx.y from its chunks' partials, summed
// in a fixed order in f64.
__device__ __forceinline__ void l2_scale(const float4* partials, float step, float eps,
                                         double* red, float& gden, float& factor) {
  const int chunks = gridDim.x;
  double tot[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < chunks; i += kL2Threads) {
    const float4 q = partials[(long long)blockIdx.y * chunks + i];
    tot[0] += q.x; tot[1] += q.y; tot[2] += q.z; tot[3] += q.w;
  }
  block_sum<4>(tot, red);
  gden = (float)sqrt(tot[0]) + 1e-10f;
  const double cs = (double)step / (double)gden;
  const float dnorm = (float)sqrt(fmax(tot[1] - 2.0 * cs * tot[2] + cs * cs * tot[3], 0.0));
  factor = dnorm > eps ? eps / (dnorm + 1e-7f) : 1.f;
}

// One output element, each operation rounded as the plain version's.
template <bool MASK>
__device__ __forceinline__ float l2_out(float x, float g, float s, float m, float gden,
                                        float step, float factor, float min_value,
                                        float max_value) {
  float gn = __fdiv_rn(g, gden);
  if constexpr (MASK) gn = __fmul_rn(gn, m);
  const float d = __fsub_rn(__fsub_rn(x, __fmul_rn(gn, step)), s);
  return min_nan(max_nan(__fadd_rn(s, __fmul_rn(d, factor)), min_value), max_value);
}

template <int V>
__device__ __forceinline__ void load_mask(const float* m, float (&mv)[V]) {
#pragma unroll
  for (int k = 0; k < V; k += 4) {
    const float4 f = *reinterpret_cast<const float4*>(m + k);
    mv[k] = f.x; mv[k + 1] = f.y; mv[k + 2] = f.z; mv[k + 3] = f.w;
  }
}

// Grid (chunks, B).  Chunk i of sample b covers pixels [i * P, (i + 1) * P)
// of every channel, P = kL2Threads * V; vectorized: thread t takes pixels
// i * P + t * V + [0, V); else pixels i * P + k * kL2Threads + t, k < V.

// The one-kernel path: vectorized, C <= kL2ResidentC, the grid resident.
template <typename E, bool MASK>
__global__ void __launch_bounds__(kL2Threads, 2)
pgd_l2_resident_kernel(const typename E::Bits* __restrict__ x_adv,
                       const typename E::Bits* __restrict__ grad,
                       const typename E::Bits* __restrict__ src, const float* __restrict__ mask,
                       float4* partials, typename E::Bits* __restrict__ out, int C, int hw,
                       float step, float eps, float min_value, float max_value) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack { uint4 u; Bits e[V]; };
  __shared__ float red[4 * 32];
  __shared__ double red2[4 * 32];
  const int b = blockIdx.y;
  const long long p = (long long)blockIdx.x * kL2Threads * V + threadIdx.x * V;
  const bool live = p < hw;
  Pack xv[kL2ResidentC], gv[kL2ResidentC], sv[kL2ResidentC];
  float mv[V];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    if constexpr (MASK) load_mask<V>(mask + (long long)b * hw + p, mv);
#pragma unroll
    for (int c = 0; c < kL2ResidentC; ++c)
      if (c < C) {
        const long long off = ((long long)b * C + c) * hw + p;
        xv[c].u = *reinterpret_cast<const uint4*>(x_adv + off);
        gv[c].u = *reinterpret_cast<const uint4*>(grad + off);
        sv[c].u = *reinterpret_cast<const uint4*>(src + off);
      }
#pragma unroll
    for (int c = 0; c < kL2ResidentC; ++c)
      if (c < C)
#pragma unroll
        for (int k = 0; k < V; ++k)
          l2_moments<MASK>(E::load(xv[c].e[k]), E::load(gv[c].e[k]), E::load(sv[c].e[k]),
                           MASK ? mv[k] : 1.f, acc);
  }
  store_partials<MASK>(acc, red, partials);
  cooperative_groups::this_grid().sync();
  float gden, factor;
  l2_scale(partials, step, eps, red2, gden, factor);
  if (!live) return;
#pragma unroll
  for (int c = 0; c < kL2ResidentC; ++c)
    if (c < C) {
      Pack ov;
#pragma unroll
      for (int k = 0; k < V; ++k)
        ov.e[k] = E::store(l2_out<MASK>(E::load(xv[c].e[k]), E::load(gv[c].e[k]),
                                        E::load(sv[c].e[k]), MASK ? mv[k] : 1.f, gden, step,
                                        factor, min_value, max_value));
      *reinterpret_cast<uint4*>(out + ((long long)b * C + c) * hw + p) = ov.u;
    }
}

// The two-kernel path, first kernel: the partials.
template <typename E, bool MASK>
__global__ void __launch_bounds__(kL2Threads)
pgd_l2_partials_kernel(const typename E::Bits* __restrict__ x_adv,
                       const typename E::Bits* __restrict__ grad,
                       const typename E::Bits* __restrict__ src, const float* __restrict__ mask,
                       float4* __restrict__ partials, int C, int hw, int vectorized) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack { uint4 u; Bits e[V]; };
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float red[4 * 32];
  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kL2Threads * V;
  const float* m = MASK ? mask + (long long)b * hw : nullptr;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (vectorized) {
    const long long p = p0 + threadIdx.x * V;
    if (p < hw) {
      float mv[V];
      if constexpr (MASK) load_mask<V>(m + p, mv);
      for (int c = 0; c < C; ++c) {
        const long long off = ((long long)b * C + c) * hw + p;
        Pack xv, gv, sv;
        xv.u = *reinterpret_cast<const uint4*>(x_adv + off);
        gv.u = *reinterpret_cast<const uint4*>(grad + off);
        sv.u = *reinterpret_cast<const uint4*>(src + off);
#pragma unroll
        for (int k = 0; k < V; ++k)
          l2_moments<MASK>(E::load(xv.e[k]), E::load(gv.e[k]), E::load(sv.e[k]),
                           MASK ? mv[k] : 1.f, acc);
      }
    }
  } else {
    for (int k = 0; k < V; ++k) {
      const long long p = p0 + k * kL2Threads + threadIdx.x;
      if (p >= hw) break;
      const float mk = MASK ? m[p] : 1.f;
      for (int c = 0; c < C; ++c) {
        const long long off = ((long long)b * C + c) * hw + p;
        l2_moments<MASK>(E::load(x_adv[off]), E::load(grad[off]), E::load(src[off]), mk, acc);
      }
    }
  }
  store_partials<MASK>(acc, red, partials);
}

// The two-kernel path, second kernel: the write.
template <typename E, bool MASK>
__global__ void __launch_bounds__(kL2Threads)
pgd_l2_write_kernel(const typename E::Bits* __restrict__ x_adv,
                    const typename E::Bits* __restrict__ grad,
                    const typename E::Bits* __restrict__ src, const float* __restrict__ mask,
                    const float4* partials, typename E::Bits* __restrict__ out, int C,
                    int hw, int vectorized, float step, float eps, float min_value,
                    float max_value) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack { uint4 u; Bits e[V]; };
  __shared__ double red[4 * 32];
  asm volatile("griddepcontrol.wait;" ::: "memory");    // the partials are written
  float gden, factor;
  l2_scale(partials, step, eps, red, gden, factor);

  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kL2Threads * V;
  const float* m = MASK ? mask + (long long)b * hw : nullptr;
  if (vectorized) {
    const long long p = p0 + threadIdx.x * V;
    if (p >= hw) return;
    float mv[V];
    if constexpr (MASK) load_mask<V>(m + p, mv);
    for (int c = 0; c < C; ++c) {
      const long long off = ((long long)b * C + c) * hw + p;
      Pack xv, gv, sv, ov;
      xv.u = *reinterpret_cast<const uint4*>(x_adv + off);
      gv.u = *reinterpret_cast<const uint4*>(grad + off);
      sv.u = *reinterpret_cast<const uint4*>(src + off);
#pragma unroll
      for (int k = 0; k < V; ++k)
        ov.e[k] = E::store(l2_out<MASK>(E::load(xv.e[k]), E::load(gv.e[k]), E::load(sv.e[k]),
                                        MASK ? mv[k] : 1.f, gden, step, factor, min_value,
                                        max_value));
      *reinterpret_cast<uint4*>(out + off) = ov.u;
    }
  } else {
    for (int k = 0; k < V; ++k) {
      const long long p = p0 + k * kL2Threads + threadIdx.x;
      if (p >= hw) break;
      const float mk = MASK ? m[p] : 1.f;
      for (int c = 0; c < C; ++c) {
        const long long off = ((long long)b * C + c) * hw + p;
        out[off] = E::store(l2_out<MASK>(E::load(x_adv[off]), E::load(grad[off]),
                                         E::load(src[off]), mk, gden, step, factor, min_value,
                                         max_value));
      }
    }
  }
}

// True when every block of `grid` can be resident on the card at once.
template <typename E, bool MASK>
cudaError_t grid_resident(dim3 grid, bool& resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pgd_l2_resident_kernel<E, MASK>,
                                                        kL2Threads, 0);
  resident = (long long)grid.x * grid.y <= (long long)per_sm * sms;
  return err;
}

template <typename E, bool MASK>
cudaError_t launch_l2(const void* x_adv, const void* grad, const void* src, const float* mask,
                      void* partials, void* out, int B, int C, int hw, float step, float eps,
                      float min_value, float max_value, cudaStream_t s) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x_adv) | reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(mask) |
                         reinterpret_cast<uintptr_t>(out);
  const int vectorized = (addr & 15) == 0 && hw % V == 0;
  const dim3 grid((hw + kL2Threads * V - 1) / (kL2Threads * V), B);
  const Bits *xa = (const Bits*)x_adv, *ga = (const Bits*)grad, *sa = (const Bits*)src;
  float4* pa = (float4*)partials;
  Bits* oa = (Bits*)out;
  bool resident = false;
  cudaError_t err = cudaSuccess;
  if (vectorized && C <= kL2ResidentC) err = grid_resident<E, MASK>(grid, resident);
  if (err != cudaSuccess) return err;
  if (resident) {
    void* args[] = {&xa, &ga, &sa, &mask, &pa, &oa, &C, &hw, &step, &eps, &min_value, &max_value};
    err = cudaLaunchCooperativeKernel((const void*)pgd_l2_resident_kernel<E, MASK>, grid,
                                      dim3(kL2Threads), args, 0, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  pgd_l2_partials_kernel<E, MASK><<<grid, kL2Threads, 0, s>>>(xa, ga, sa, mask, pa, C, hw,
                                                              vectorized);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kL2Threads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pgd_l2_write_kernel<E, MASK>, xa, ga, sa, mask,
                           (const float4*)pa, oa, C, hw, vectorized, step, eps, min_value,
                           max_value);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---- K5, the L-inf update ---------------------------------------------------
//
// Replaces: tml_image_editing_defense_tpu/ops/pgd_kernels.py
//   _linf_kernel (the pallas_call in pgd_linf_update).
// Elementwise, which is attack/pgd.py::linf_perturbation_step:
//   x  <- x_adv - sign(grad) * step
//   x  <- min(max(x, src - eps), src + eps)
//   out = min(max(x, min), max)
// sign(0) = 0 (a zero gradient leaves x as it is), and sign(NaN) = 0, as
// torch.sign gives them; min and max propagate NaN.  In f32
// every operation is one exactly rounded subtraction or addition, or a
// min/max, so the result is bit-equal to the plain version.  In bf16 the
// kernel computes in f32 and rounds to bf16 after each operation where
// PyTorch's bf16 ops round (the product, the difference, src -/+ eps).
//
// What bounds it on the H100: bytes.  Three reads and one write per element
// and ~8 operations: 12.6 MB at [1, 3, 512, 512] f32, 3.8 us at 3.35 TB/s.
// The design streams at that rate: one grid-stride pass, 16-byte loads and
// stores (four f32 or eight bf16 values a thread), a scalar tail for a size
// that is no multiple of the vector width, and a scalar path when a pointer
// is not 16-byte aligned.  At these sizes the launch itself costs about as
// much as the bytes.

__device__ __forceinline__ float sign0(float g) { return (float)((g > 0.f) - (g < 0.f)); }

template <typename E>
__device__ __forceinline__ typename E::Bits linf_elem(typename E::Bits xb, typename E::Bits gb,
                                                      typename E::Bits sb, float step, float eps,
                                                      float min_value, float max_value) {
  const float s = E::load(sb);
  float x = E::round(E::load(xb) - E::round(sign0(E::load(gb)) * step));
  x = min_nan(max_nan(x, E::round(s - eps)), E::round(s + eps));
  return E::store(min_nan(max_nan(x, min_value), max_value));
}

template <typename E>
__global__ void __launch_bounds__(256)
pgd_linf_kernel(const typename E::Bits* __restrict__ x_adv,
                const typename E::Bits* __restrict__ grad,
                const typename E::Bits* __restrict__ src, typename E::Bits* __restrict__ out,
                long long n, int vectorized, float step, float eps, float min_value,
                float max_value) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Pack { uint4 u; Bits e[V]; };
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vectorized) {
    const long long nv = n / V;
    for (long long i = tid; i < nv; i += stride) {
      Pack xv, gv, sv, ov;
      xv.u = reinterpret_cast<const uint4*>(x_adv)[i];
      gv.u = reinterpret_cast<const uint4*>(grad)[i];
      sv.u = reinterpret_cast<const uint4*>(src)[i];
#pragma unroll
      for (int k = 0; k < V; ++k)
        ov.e[k] = linf_elem<E>(xv.e[k], gv.e[k], sv.e[k], step, eps, min_value, max_value);
      reinterpret_cast<uint4*>(out)[i] = ov.u;
    }
    done = nv * V;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = linf_elem<E>(x_adv[i], grad[i], src[i], step, eps, min_value, max_value);
}

template <typename E>
void launch_linf(const void* x_adv, const void* grad, const void* src, void* out, long long n,
                 float step, float eps, float min_value, float max_value, cudaStream_t s) {
  using Bits = typename E::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x_adv) | reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0;
  const long long work = aligned ? n / V + V : n;    // vectors, plus the tail's few elements
  const long long blocks = (work + 255) / 256;
  const int grid = (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
  pgd_linf_kernel<E><<<grid, 256, 0, s>>>((const Bits*)x_adv, (const Bits*)grad,
                                          (const Bits*)src, (Bits*)out, n, aligned ? 1 : 0, step,
                                          eps, min_value, max_value);
}

}  // namespace

extern "C" int tid_pgd_linf_update(const void* x_adv, const void* grad, const void* src,
                                   void* out, long long n, int is_bf16, float step, float eps,
                                   float min_value, float max_value, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch_linf<BF16Elem>(x_adv, grad, src, out, n, step, eps, min_value, max_value, s);
  else
    launch_linf<F32Elem>(x_adv, grad, src, out, n, step, eps, min_value, max_value, s);
  return (int)cudaGetLastError();
}

// K4: one kernel or two, one call.  `partials` is the wrapper's scratch of
// B * ceil(hw / (256 * 16 / item)) float4s.  Two C entries, one without a
// mask (_l2_kernel) and one with a [B, hw] f32 mask (_l2_masked_kernel), so
// that each has its own launch count.
namespace {

template <bool MASK>
cudaError_t l2_update(const void* x_adv, const void* grad, const void* src, const float* m,
                      void* partials, void* out, int B, int C, int hw, int is_bf16, float step,
                      float eps, float min_value, float max_value, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_l2<BF16Elem, MASK>(x_adv, grad, src, m, partials, out, B, C, hw, step, eps,
                                     min_value, max_value, s);
  return launch_l2<F32Elem, MASK>(x_adv, grad, src, m, partials, out, B, C, hw, step, eps,
                                  min_value, max_value, s);
}

}  // namespace

extern "C" int tid_pgd_l2_update(const void* x_adv, const void* grad, const void* src,
                                 void* partials, void* out, int B, int C, int hw, int is_bf16,
                                 float step, float eps, float min_value, float max_value,
                                 void* stream) {
  return (int)l2_update<false>(x_adv, grad, src, nullptr, partials, out, B, C, hw, is_bf16, step,
                               eps, min_value, max_value, stream);
}

extern "C" int tid_pgd_l2_update_masked(const void* x_adv, const void* grad, const void* src,
                                        const void* mask, void* partials, void* out, int B, int C,
                                        int hw, int is_bf16, float step, float eps,
                                        float min_value, float max_value, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  return (int)l2_update<true>(x_adv, grad, src, (const float*)mask, partials, out, B, C, hw,
                              is_bf16, step, eps, min_value, max_value, stream);
}
