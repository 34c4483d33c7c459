// Flash self-attention for Hopper (sm_90a): forward (K1) and the flash-2
// backward in two kernels, dK/dV (K2) and dQ (K3).
//
// Replaces: tml_image_editing_defense_tpu/ops/flash_attention.py
//   _fwd_kernel    (K1, pallas_call in _fwd)
//   _bwd_kv_kernel (K2, first pallas_call in _bwd)
//   _bwd_q_kernel  (K3, second pallas_call in _bwd)
// Same math: online softmax with f32 running max/denominator/accumulator,
// lse = m + log l as the residual, p = exp(s - lse) recomputed per tile in
// the backward, dS = p * (dO.V^T - delta) * scale with delta = rowsum(dO*O)
// computed outside the kernels (a plain torch op, as in the JAX version).
//
// Layout: q/k/v/o/dq/dk/dv are [B, T, H, D] contiguous (what the attention
// layers produce, no transpose); lse and delta are [B, T, H] f32.  Self-
// attention only (T == S), no mask, softmax scale passed in (1/sqrt(D)).
//
// What bounds it on the H100: at the main path's shapes (B*H = 16, T = 4096,
// D = 40; and B*H = 1, T = 4096, D = 512) the work is the two [T x T x D]
// products per (b, h) -- 2*T^2*D FMAs each way -- while the bytes are only
// the [T, D] operands, so attention is bound by operations.  In f32 that
// means the 67 TFLOP/s of the CUDA cores.  The design keeps the T x T scores
// out of device memory entirely (the plain version writes and re-reads a
// [B*H, T, T] f32 tensor per layer, 1 GB at the UNet shape): every tile of
// S / P / dS lives in shared memory and registers only.  Each thread owns a
// register micro-tile of every product (S = QK^T, dP = dO V^T, and the
// O / dQ / dK / dV accumulators), so a shared-memory operand load feeds
// several FMAs; row pitches of D+1 and BK+1 floats keep column walks on
// distinct banks.  The inner loops are CUDA-core FMAs in f32 (bf16 inputs are
// widened on load), so f32 here is true f32.  Not done yet (later work):
// tensor cores (wgmma) for bf16 inputs, TMA/cp.async double buffering, and a
// larger per-thread tile at D = 512, where the S product is bound by shared-
// memory loads rather than FMAs.
//
// The tile plan depends on D.  D in {40, 64, 80}: 64-row Q and KV tiles, 128
// threads.  D = 512 (the VAE mid-block): a 64-row tile of Q, K and V in f32
// would need 394 KB of shared memory, over the 227 KB a block may use, so the
// tiles shrink to 32 or 16 rows and the [rows x 512] accumulators spread over
// 256 threads (16 columns each).  Ragged tails (T not a multiple of the
// tile) are masked, so any T is legal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Reductions over the W neighbouring lanes that share one row.
template <int W> __device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int W> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ROWS rows of one (b, h) slice, starting at row0, into shared memory as f32
// with row pitch LD.  Rows at or past T are zero.
template <typename T, int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* s, const T* __restrict__ g, int row0,
                                          int T_len, int row_stride) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int t = row0 + r;
    s[r * LD + c] = t < T_len ? to_f(g[(size_t)t * row_stride + c]) : 0.f;
  }
}

// out[i][j] = sum_d A[ra(i)][d] * B[cb(j)][d], ra(i) = ty + TY*i, cb(j) = tx + TX*j.
template <int RM, int RN, int TX, int TY, int D, int LDA, int LDB>
__device__ __forceinline__ void mm_abt(float (&out)[RM][RN], const float* A, const float* B,
                                       int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty + TY * i) * LDA + d];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = B[(tx + TX * j) * LDB + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// acc[i][j] += sum_k a(ra(i), k) * B[k][cb(j)], with a(r, k) = A[r][k], or
// A[k][r] when TRANS.  ra(i) = ty + TY*i, cb(j) = tx + TX*j.
template <int RM, int RN, int TX, int TY, int K, int LDA, int LDB, bool TRANS>
__device__ __forceinline__ void mm_acc(float (&acc)[RM][RN], const float* A, const float* B,
                                       int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = TRANS ? A[k * LDA + ty + TY * i] : A[(ty + TY * i) * LDA + k];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = B[k * LDB + tx + TX * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Thread layouts.  "S layout" covers a [ROWS x COLS] score tile: TXS lanes
// across the columns (one row's lanes are neighbours in one warp, so row
// reductions are shuffles), rows strided by NT/TXS.  "O layout" covers a
// [ROWS x D] accumulator: TXO lanes across D, rows strided by NT/TXO.
template <int NT, int TXS, int TXO, int ROWS_S, int COLS_S, int ROWS_O, int D>
struct Layout {
  static constexpr int TYS = NT / TXS, RS = ROWS_S / TYS, CS = COLS_S / TXS;
  static constexpr int TYO = NT / TXO, RO = ROWS_O / TYO, CO = D / TXO;
  static_assert(TXS <= 32 && (TXS & (TXS - 1)) == 0, "row lanes must sit in one warp");
  static_assert(RS * TYS == ROWS_S && CS * TXS == COLS_S, "score tile does not divide");
  static_assert(RO * TYO == ROWS_O && CO * TXO == D, "accumulator tile does not divide");
};

// ---------------------------------------------------------------------------
// K1: forward.  Grid (ceil(T/BQ), B*H); one block per (b*h, BQ-row Q tile),
// looping over the KV tiles (the TPU grid's sequential axis).
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK, int NT, int TXS, int TXO>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_len, int H, float scale) {
  using L = Layout<NT, TXS, TXO, BQ, BK, BQ, D>;
  constexpr int LD = D + 1, LDS = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sCorr = sP + BQ * LDS;
  float* sL = sCorr + BQ;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D;
  const int tid = threadIdx.x;
  const int txs = tid % TXS, tys = tid / TXS, txo = tid % TXO, tyo = tid / TXO;

  load_rows<T, D, LD, BQ, NT>(sQ, q + base, q0, T_len, rs);
  float m[L::RS], l[L::RS];
#pragma unroll
  for (int i = 0; i < L::RS; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  float acc[L::RO][L::CO];
#pragma unroll
  for (int i = 0; i < L::RO; ++i)
#pragma unroll
    for (int j = 0; j < L::CO; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += BK) {
    load_rows<T, D, LD, BK, NT>(sK, k + base, k0, T_len, rs);
    load_rows<T, D, LD, BK, NT>(sV, v + base, k0, T_len, rs);
    __syncthreads();
    float s[L::RS][L::CS];
    mm_abt<L::RS, L::CS, TXS, L::TYS, D, LD, LD>(s, sQ, sK, txs, tys);
#pragma unroll
    for (int i = 0; i < L::RS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < L::CS; ++j) {
        const bool ok = k0 + txs + TXS * j < T_len;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<TXS>(mx);
      const float m_new = fmaxf(m[i], mx);   // finite: column k0 is always valid
      float sum = 0.f;
      const int r = tys + L::TYS * i;
#pragma unroll
      for (int j = 0; j < L::CS; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[r * LDS + txs + TXS * j] = p;
        sum += p;
      }
      sum = group_sum<TXS>(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
      if (txs == 0) sCorr[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::RO; ++i) {
      const float c = sCorr[tyo + L::TYO * i];
#pragma unroll
      for (int j = 0; j < L::CO; ++j) acc[i][j] *= c;
    }
    mm_acc<L::RO, L::CO, TXO, L::TYO, BK, LDS, LD, false>(acc, sP, sV, txo, tyo);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < L::RS; ++i) {
    const int r = tys + L::TYS * i, t = q0 + r;
    if (txs == 0) {
      sL[r] = l[i];
      if (t < T_len) lse[((size_t)b * T_len + t) * H + h] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::RO; ++i) {
    const int r = tyo + L::TYO * i, t = q0 + r;
    if (t >= T_len) continue;
    const float denom = sL[r];
#pragma unroll
    for (int j = 0; j < L::CO; ++j)
      o[base + (size_t)t * rs + txo + TXO * j] = from_f<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------------
// K2: dK, dV.  Grid (ceil(T/BK), B*H); one block per (b*h, BK-row KV tile),
// looping over the Q tiles.  K and V stay in shared memory; per Q tile:
//   P = exp(S - lse); dV += P^T dO; dP = dO V^T; dS = P (dP - delta) scale;
//   dK += dS^T Q.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK, int NT, int TXS, int TXO>
__global__ void __launch_bounds__(NT)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int T_len, int H, float scale) {
  using L = Layout<NT, TXS, TXO, BQ, BK, BK, D>;   // scores [BQ x BK], accumulators [BK x D]
  constexpr int LD = D + 1, LDS = BK + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sLse = sP + BQ * LDS;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D;
  const int tid = threadIdx.x;
  const int txs = tid % TXS, tys = tid / TXS, txo = tid % TXO, tyo = tid / TXO;

  load_rows<T, D, LD, BK, NT>(sK, k + base, k0, T_len, rs);
  load_rows<T, D, LD, BK, NT>(sV, v + base, k0, T_len, rs);
  float dk_acc[L::RO][L::CO], dv_acc[L::RO][L::CO];
#pragma unroll
  for (int i = 0; i < L::RO; ++i)
#pragma unroll
    for (int j = 0; j < L::CO; ++j) { dk_acc[i][j] = 0.f; dv_acc[i][j] = 0.f; }

  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    load_rows<T, D, LD, BQ, NT>(sQ, q + base, q0, T_len, rs);
    load_rows<T, D, LD, BQ, NT>(sdO, dout + base, q0, T_len, rs);
    for (int r = tid; r < BQ; r += NT) {
      const int t = q0 + r;   // padded rows: dO = 0 and delta = 0, so they add nothing
      const size_t si = ((size_t)b * T_len + t) * H + h;
      sLse[r] = t < T_len ? lse[si] : 0.f;
      sDelta[r] = t < T_len ? delta[si] : 0.f;
    }
    __syncthreads();
    float p[L::RS][L::CS], dp[L::RS][L::CS];
    mm_abt<L::RS, L::CS, TXS, L::TYS, D, LD, LD>(p, sQ, sK, txs, tys);
    mm_abt<L::RS, L::CS, TXS, L::TYS, D, LD, LD>(dp, sdO, sV, txs, tys);
#pragma unroll
    for (int i = 0; i < L::RS; ++i) {
      const int r = tys + L::TYS * i;
      const float lr = sLse[r];
#pragma unroll
      for (int j = 0; j < L::CS; ++j) {
        const bool ok = k0 + txs + TXS * j < T_len;
        p[i][j] = ok ? expf(p[i][j] * scale - lr) : 0.f;
        sP[r * LDS + txs + TXS * j] = p[i][j];
      }
    }
    __syncthreads();
    mm_acc<L::RO, L::CO, TXO, L::TYO, BQ, LDS, LD, true>(dv_acc, sP, sdO, txo, tyo);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::RS; ++i) {
      const int r = tys + L::TYS * i;
      const float dr = sDelta[r];
#pragma unroll
      for (int j = 0; j < L::CS; ++j)
        sP[r * LDS + txs + TXS * j] = p[i][j] * (dp[i][j] - dr) * scale;
    }
    __syncthreads();
    mm_acc<L::RO, L::CO, TXO, L::TYO, BQ, LDS, LD, true>(dk_acc, sP, sQ, txo, tyo);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < L::RO; ++i) {
    const int t = k0 + tyo + L::TYO * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < L::CO; ++j) {
      const size_t gi = base + (size_t)t * rs + txo + TXO * j;
      dk[gi] = from_f<T>(dk_acc[i][j]);
      dv[gi] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dQ.  Grid (ceil(T/BQ), B*H); one block per (b*h, BQ-row Q tile),
// looping over the KV tiles:  dQ += dS K.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK, int NT, int TXS, int TXO>
__global__ void __launch_bounds__(NT)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int T_len, int H,
                   float scale) {
  using L = Layout<NT, TXS, TXO, BQ, BK, BQ, D>;   // scores [BQ x BK], accumulator [BQ x D]
  constexpr int LD = D + 1, LDS = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D;
  const int tid = threadIdx.x;
  const int txs = tid % TXS, tys = tid / TXS, txo = tid % TXO, tyo = tid / TXO;

  load_rows<T, D, LD, BQ, NT>(sQ, q + base, q0, T_len, rs);
  load_rows<T, D, LD, BQ, NT>(sdO, dout + base, q0, T_len, rs);
  float lr[L::RS], dr[L::RS];
#pragma unroll
  for (int i = 0; i < L::RS; ++i) {
    const int t = q0 + tys + L::TYS * i;
    const size_t si = ((size_t)b * T_len + t) * H + h;
    lr[i] = t < T_len ? lse[si] : 0.f;
    dr[i] = t < T_len ? delta[si] : 0.f;
  }
  float dq_acc[L::RO][L::CO];
#pragma unroll
  for (int i = 0; i < L::RO; ++i)
#pragma unroll
    for (int j = 0; j < L::CO; ++j) dq_acc[i][j] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += BK) {
    load_rows<T, D, LD, BK, NT>(sK, k + base, k0, T_len, rs);
    load_rows<T, D, LD, BK, NT>(sV, v + base, k0, T_len, rs);
    __syncthreads();
    float p[L::RS][L::CS], dp[L::RS][L::CS];
    mm_abt<L::RS, L::CS, TXS, L::TYS, D, LD, LD>(p, sQ, sK, txs, tys);
    mm_abt<L::RS, L::CS, TXS, L::TYS, D, LD, LD>(dp, sdO, sV, txs, tys);
#pragma unroll
    for (int i = 0; i < L::RS; ++i) {
      const int r = tys + L::TYS * i;
#pragma unroll
      for (int j = 0; j < L::CS; ++j) {
        const bool ok = k0 + txs + TXS * j < T_len;
        const float pij = ok ? expf(p[i][j] * scale - lr[i]) : 0.f;
        sP[r * LDS + txs + TXS * j] = pij * (dp[i][j] - dr[i]) * scale;
      }
    }
    __syncthreads();
    mm_acc<L::RO, L::CO, TXO, L::TYO, BK, LDS, LD, false>(dq_acc, sP, sK, txo, tyo);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < L::RO; ++i) {
    const int t = q0 + tyo + L::TYO * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < L::CO; ++j)
      dq[base + (size_t)t * rs + txo + TXO * j] = from_f<T>(dq_acc[i][j]);
  }
}

// Tile plans.  Small heads: 64x64 tiles, 128 threads.  D = 512: see the note
// at the top (shared memory caps the tiles at 32 / 16 rows).
template <int D> struct Plan {
  static constexpr int NT = 128, TXS = 16, TXO = 8;
  static constexpr int FWD_BQ = 64, FWD_BK = 64;
  static constexpr int KV_BQ = 64, KV_BK = 64;
  static constexpr int Q_BQ = 64, Q_BK = 64;
};
template <> struct Plan<512> {
  static constexpr int NT = 256, TXS = 16, TXO = 32;
  static constexpr int FWD_BQ = 32, FWD_BK = 32;
  static constexpr int KV_BQ = 32, KV_BK = 16;
  static constexpr int Q_BQ = 16, Q_BK = 32;
};

constexpr size_t fwd_smem(int D, int BQ, int BK) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1) + 2 * BQ);
}
constexpr size_t bwd_smem(int D, int BQ, int BK) {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1) + 2 * BQ);
}

template <typename KernelFn>
cudaError_t allow_smem(KernelFn fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T_len,
               int H, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  auto fn = flash_fwd_kernel<T, D, P::FWD_BQ, P::FWD_BK, P::NT, P::TXS, P::TXO>;
  const size_t smem = fwd_smem(D, P::FWD_BQ, P::FWD_BK);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + P::FWD_BQ - 1) / P::FWD_BQ, B * H);
  fn<<<grid, P::NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                                     T_len, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_kv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int B, int T_len, int H, float scale,
                  cudaStream_t stream) {
  using P = Plan<D>;
  auto fn = flash_bwd_kv_kernel<T, D, P::KV_BQ, P::KV_BK, P::NT, P::TXS, P::TXO>;
  const size_t smem = bwd_smem(D, P::KV_BQ, P::KV_BK);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + P::KV_BK - 1) / P::KV_BK, B * H);
  fn<<<grid, P::NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                     (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                                     T_len, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_q_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int T_len, int H, float scale,
                 cudaStream_t stream) {
  using P = Plan<D>;
  auto fn = flash_bwd_q_kernel<T, D, P::Q_BQ, P::Q_BK, P::NT, P::TXS, P::TXO>;
  const size_t smem = bwd_smem(D, P::Q_BQ, P::Q_BK);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + P::Q_BQ - 1) / P::Q_BQ, B * H);
  fn<<<grid, P::NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                     (const float*)lse, (const float*)delta, (T*)dq, T_len, H,
                                     scale);
  return (int)cudaGetLastError();
}

// Head dims with a compiled plan; the Python wrapper lists the same set.
#define TID_FOR_EACH_HEAD_DIM(X) X(40) X(64) X(80) X(512)

}  // namespace

extern "C" {

const char* tid_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int tid_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T_len,
                  int H, int D, int is_bf16, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TID_CASE(DD)                                                                        \
  case DD:                                                                                  \
    return is_bf16 ? fwd_launch<__nv_bfloat16, DD>(q, k, v, o, lse, B, T_len, H, scale, s) \
                   : fwd_launch<float, DD>(q, k, v, o, lse, B, T_len, H, scale, s);
  switch (D) { TID_FOR_EACH_HEAD_DIM(TID_CASE) }
#undef TID_CASE
  return (int)cudaErrorInvalidValue;
}

int tid_flash_bwd_kv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int T_len,
                     int H, int D, int is_bf16, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TID_CASE(DD)                                                                      \
  case DD:                                                                                \
    return is_bf16 ? bwd_kv_launch<__nv_bfloat16, DD>(q, k, v, dout, lse, delta, dk, dv, \
                                                      B, T_len, H, scale, s)              \
                   : bwd_kv_launch<float, DD>(q, k, v, dout, lse, delta, dk, dv, B, T_len, \
                                              H, scale, s);
  switch (D) { TID_FOR_EACH_HEAD_DIM(TID_CASE) }
#undef TID_CASE
  return (int)cudaErrorInvalidValue;
}

int tid_flash_bwd_q(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int B, int T_len, int H, int D,
                    int is_bf16, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define TID_CASE(DD)                                                                    \
  case DD:                                                                              \
    return is_bf16 ? bwd_q_launch<__nv_bfloat16, DD>(q, k, v, dout, lse, delta, dq, B,  \
                                                     T_len, H, scale, s)                \
                   : bwd_q_launch<float, DD>(q, k, v, dout, lse, delta, dq, B, T_len, H, \
                                             scale, s);
  switch (D) { TID_FOR_EACH_HEAD_DIM(TID_CASE) }
#undef TID_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
