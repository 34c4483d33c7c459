// Fused PGD perturbation updates for Hopper (sm_90a): L2 (K4) and L-inf (K5).
//
// ---- K4, the L2 update ------------------------------------------------------
//
// Replaces: tml_image_editing_defense_tpu/ops/pgd_kernels.py
//   _l2_kernel and _l2_masked_kernel (the pallas_calls in pgd_l2_update).
// Per sample b, in f32, result cast back to the input dtype:
//   g  <- grad / (||grad|| + 1e-10), times mask[b, 0, y, x] when a mask is given
//   x  <- x_adv - g * step
//   d  <- x - src;  d <- d * eps / (||d|| + 1e-7)  when ||d|| > eps
//   out = clip(src + d, min, max)
// which is attack/pgd.py::l2_perturbation_step with per-sample norms (the
// Pallas kernel takes batch 1 only).
//
// What bounds it on the H100: bytes.  It does ~15 operations per element
// and must read x, grad and src (and the mask) and write the output once:
// 12.6 MB at [1, 3, 512, 512] f32, 3.8 us at 3.35 TB/s.  The two norms
// depend on each other (||d|| needs the normalised gradient), so the kernel
// makes three passes over the sample -- ||g||^2, then ||d||^2 with d formed on
// the fly, then the write -- inside one block per sample, so that both
// reductions stay in the block (warp shuffles, then one shared-memory step)
// and no second launch or grid-wide barrier is needed.  The price is that
// one SM streams the whole image, far from the card's bandwidth; the update
// runs once per PGD iteration, next to seconds of model work.  A cluster of
// blocks sharing the partial sums through distributed shared memory is the
// way to the bound, in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the block; every thread gets the total.  `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();   // red is reused by the next call
  return v;
}

// One block per sample; n = C*H*W elements per sample, hw = H*W (mask stride).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pgd_l2_kernel(const T* __restrict__ x_adv, const T* __restrict__ grad, const T* __restrict__ src,
              const float* __restrict__ mask, T* __restrict__ out, int n, int hw, float step,
              float eps, float min_value, float max_value) {
  __shared__ float red[32];
  const size_t off = (size_t)blockIdx.x * n;
  x_adv += off; grad += off; src += off; out += off;
  const float* m = mask ? mask + (size_t)blockIdx.x * hw : nullptr;

  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float g = to_f(grad[i]);
    acc = fmaf(g, g, acc);
  }
  const float gden = sqrtf(block_sum(acc, red)) + 1e-10f;

  acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float g = to_f(grad[i]) / gden;
    if (m) g *= m[i % hw];
    const float d = (to_f(x_adv[i]) - g * step) - to_f(src[i]);
    acc = fmaf(d, d, acc);
  }
  const float dnorm = sqrtf(block_sum(acc, red));
  const float factor = dnorm > eps ? eps / (dnorm + 1e-7f) : 1.f;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    float g = to_f(grad[i]) / gden;
    if (m) g *= m[i % hw];
    const float s = to_f(src[i]);
    const float d = (to_f(x_adv[i]) - g * step) - s;
    out[i] = from_f<T>(fminf(fmaxf(s + d * factor, min_value), max_value));
  }
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
// torch.sign gives them; min and max propagate NaN, as torch.minimum,
// torch.maximum and torch.clamp do (fminf/fmaxf would drop it).  In f32
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

__device__ __forceinline__ float sign0(float g) { return (float)((g > 0.f) - (g < 0.f)); }
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

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

extern "C" int tid_pgd_l2_update(const void* x_adv, const void* grad, const void* src,
                                 const void* mask, void* out, int B, int n, int hw, int is_bf16,
                                 float step, float eps, float min_value, float max_value,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    pgd_l2_kernel<__nv_bfloat16><<<B, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x_adv, (const __nv_bfloat16*)grad, (const __nv_bfloat16*)src,
        (const float*)mask, (__nv_bfloat16*)out, n, hw, step, eps, min_value, max_value);
  else
    pgd_l2_kernel<float><<<B, kThreads, 0, s>>>((const float*)x_adv, (const float*)grad,
                                                (const float*)src, (const float*)mask,
                                                (float*)out, n, hw, step, eps, min_value,
                                                max_value);
  return (int)cudaGetLastError();
}
