// Fused L2 PGD perturbation update (K4) for Hopper (sm_90a).
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

}  // namespace

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
