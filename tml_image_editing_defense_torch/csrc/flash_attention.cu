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
// Ragged tails (T not a multiple of a tile) are masked, so any T is legal.
//
// What bounds attention on the H100: at the main path's shapes (B*H = 16,
// T = 4096, D = 40; and B*H = 1 or 8, T = 4096, D = 512) the work is the
// [T x T x D] products per (b, h), 2*T^2*D FMAs each, while the bytes are
// only the [T, D] operands, so every kernel here is bound by operations.
// All of them keep the T x T scores out of device memory (the plain version
// writes and re-reads a [B*H, T, T] f32 tensor per layer, 1 GB at the UNet
// shape): each tile of S / P / dS lives in registers and shared memory only.
//
// K1 (forward) runs its products as CUDA-core f32 FMAs, so its bound is the
// 67 TFLOP/s of the CUDA cores.  Each thread owns a register micro-tile of
// S = QK^T and of the O accumulator, so a shared-memory operand load feeds
// several FMAs; row pitches of D+1 and BK+1 floats keep column walks on
// distinct banks; at D = 512 a 64-row f32 tile of Q, K and V would need
// 394 KB of shared memory, so its tiles shrink to 32 rows.  Its shared-memory
// loads, two per FMA at D = 512, are what hold it back.
//
// K2 and K3 (backward) run all five products -- S = QK^T, dP = dO V^T,
// dV += P^T dO, dK += dS^T Q, dQ += dS K -- on the tensor cores with
// mma.sync.m16n8k8 in TF32, so they are bound by operations at the tensor
// cores' TF32 rate.
//  - f32 inputs: "3xTF32".  Each operand x is split in registers, as its
//    fragment is loaded, into hi = tf32(x), rounded to nearest with ties
//    away from zero as cvt.rna.tf32.f32 rounds (done with two integer ops,
//    cheaper than that conversion on sm_90), and lo = x - hi, which the
//    tensor core reads as TF32 by dropping its low bits (as CUTLASS's
//    fast-f32 products do); a*b = alo*bhi + ahi*blo + ahi*bhi.  The dropped
//    alo*blo and the truncation of lo cost ~2^-21 relative, so the result
//    is f32-accurate at a third of the 495 TFLOP/s TF32 rate, 165 TFLOP/s,
//    2.5x the CUDA cores'.  Shared memory holds each tile once, as the
//    input type.
//  - bf16 inputs: a bf16 value is exact in TF32, so one pass; P and dS round
//    to TF32's 10 mantissa bits, finer than the bf16 output's 8.  The pass
//    count is a compile-time parameter of one code path.
//  - mma.sync, not wgmma: wgmma takes TF32 operands only K-major, and three
//    of the five products contract over a tile's rows (P^T dO, dS^T Q,
//    dS K).  mma.sync loads each fragment from shared memory in whichever
//    orientation the tile sits.  Its ceiling on an H100 is about 320
//    TFLOP/s in TF32 (two thirds of wgmma's), 107 in 3xTF32.
//  - Two kernels, no atomics: K2 owns a KV tile and loops over the Q tiles,
//    K3 owns a Q tile and loops over the KV tiles, as the TPU grid's
//    sequential axis did, so results are the same from run to run.
//  - The streamed tiles (Q, dO, lse, delta in K2; K, V in K3) arrive by
//    cp.async (16 bytes, .cg) in a two-stage ring, so the next tile's load
//    overlaps this tile's products; rows past T are zero-filled with a
//    source size of 0.  Row pitches are padded to W 32-bit words with
//    W = 4 mod 8, which makes every fragment load below free of bank
//    conflicts (row-major walks hit banks g*W + t, row walks 2t*W + g).
//  - A C tile reused as the next product's A operand stays in registers: a
//    product's contraction order is free, so k-slot t stands for column 2t
//    and slot t+4 for column 2t+1, and the B operand is read from rows 2t,
//    2t+1 to match.
//
// Tile plans (BwdPlan), reckoned from shared memory (227 KB a block) and
// registers (255 a thread):
//  - D <= 80: 64-row tiles, 4 warps, each warp 16 rows of the 64 x 64 score
//    tile (the flash-2 layout), so S / dP -> P / dS -> dV, dK (or dQ) stay in
//    one warp's registers.  f32 D = 40: 68 KB of shared memory, 3
//    blocks/SM.
//  - D = 512: a 64-row f32 tile is 132 KB, so the tiles are 16 rows and 8
//    warps split each product.  S and dP [16 x 16] over D = 512: warp w
//    takes one of the two products and one quarter of D (16 k-steps) with
//    its A fragments (the resident tile's) split once into registers (128 a
//    thread), and writes its partial tile to shared memory; after a barrier
//    every thread sums the four quarters of one element and forms P and dS
//    there; after another, warp w accumulates dV, dK (dQ) for D columns
//    [64 w, 64 w + 64) (64 or 32 accumulator registers a thread).  Shared
//    memory, f32: the two resident 16-row tiles (66 KB), the ring's two
//    stages of two 16-row tiles (132 KB) and the partial scores (12 KB),
//    one block per SM.  A 32-row resident tile would need twice the
//    registers for its A fragments, which the register file does not have.
// What holds the D = 512 plan back (H100, f32, B*H = 8): each block reads
// every streamed row for 16 resident rows, 66 KB of L2 traffic a tile, and
// those copies and the products slow each other; without the copies K2 and
// K3 take two thirds to three quarters of their time, with half the rows
// copied 85 %.
// Later work: sharing the streamed tiles between the blocks of a cluster
// (TMA multicast), wgmma and TMA for the bf16 path, and K1 on the tensor
// cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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

// acc[i][j] += sum_k A[ra(i)][k] * B[k][cb(j)], ra(i) = ty + TY*i, cb(j) = tx + TX*j.
template <int RM, int RN, int TX, int TY, int K, int LDA, int LDB>
__device__ __forceinline__ void mm_acc(float (&acc)[RM][RN], const float* A, const float* B,
                                       int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty + TY * i) * LDA + k];
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
    mm_acc<L::RO, L::CO, TXO, L::TYO, BK, LDS, LD>(acc, sP, sV, txo, tyo);
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
// Tensor-core building blocks of K2 and K3.
//
// m16n8k8 TF32 fragments (PTX ISA, mma.m16n8k8), lane = 4 g + t:
//   A (16 x 8):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8):   b0 (t, g), b1 (t+4, g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// tf32(x) rounded to nearest, ties away from zero -- what cvt.rna.tf32.f32
// computes -- on the integer pipe: add half of the 13 dropped bits' range to
// the magnitude, then clear them.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// N operand values of one lane: hi = tf32(x) and, with three passes, the
// remainder lo = x - hi (exact in f32, at most 2^-11 |x|), which the tensor
// core reads as TF32 by dropping its 13 low bits, as CUTLASS's fast-f32
// products do: the error of lo is then at most 2^-21 |x|.
template <int PASSES, int N> struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = tf32_rna(x);
    if constexpr (PASSES == 3) lo[i] = __float_as_uint(x - __uint_as_float(hi[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in PASSES tensor-core passes (the small terms first).
template <int PASSES>
__device__ __forceinline__ void mma(float (&c)[4], const Frag<PASSES, 4>& a,
                                    const Frag<PASSES, 2>& b) {
  static_assert(PASSES == 1 || PASSES == 3, "one pass (bf16) or three (f32)");
  if constexpr (PASSES == 3) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
  }
  mma_tf32(c, a.hi, b.hi);
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of one (b, h) slice, from row0, into shared memory (pitch LDT
// elements) by 16-byte cp.async; rows at or past T are zero-filled.
template <typename T, int D, int LDT, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(T* s, const T* g, int row0, int T_len, int rs) {
  constexpr int V = 16 / sizeof(T), CH = D / V, N = ROWS * CH;
  static_assert(CH * V == D, "rows must be whole 16-byte chunks");
#pragma unroll
  for (int j = 0; j < (N + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (N % NT != 0 && i >= N) break;
    const int r = i / CH, c = (i - r * CH) * V, t = row0 + r;
    const bool ok = t < T_len;
    cp_async_16(s + r * LDT + c, g + (size_t)(ok ? t : 0) * rs + c, ok);
  }
}

// ROWS row statistics of one (b, h) ([B, T, H] f32, so stride H), from row0;
// rows at or past T are 0.
template <int ROWS, int NT>
__device__ __forceinline__ void copy_stats(float* s, const float* g, int row0, int T_len, int H) {
  static_assert(ROWS <= NT, "one row a thread");
  const int r = threadIdx.x, t = row0 + r;
  if (r >= ROWS) return;
  const bool ok = t < T_len;
  cp_async_4(s + r, g + (size_t)(ok ? t : 0) * H, ok);
}

// A fragment of rows 0..15, columns [c0, c0 + 8) of a row-major tile.
template <int PASSES, typename T, int LDT>
__device__ __forceinline__ void load_a(Frag<PASSES, 4>& a, const T* sA, int c0, int g, int t) {
  const T* p = sA + g * LDT + c0 + t;
  a.set(0, to_f(p[0]));
  a.set(1, to_f(p[8 * LDT]));
  a.set(2, to_f(p[4]));
  a.set(3, to_f(p[8 * LDT + 4]));
}

// X[16 x 8 NJ] += A . B[rows 0..8 NJ-1, columns [c0, c0 + 8)]^T (one k-step).
template <int PASSES, int NJ, typename T, int LDT>
__device__ __forceinline__ void mma_bt(float (&x)[NJ][4], const Frag<PASSES, 4>& a, const T* sB,
                                       int c0, int g, int t) {
  const T* p = sB + g * LDT + c0 + t;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    Frag<PASSES, 2> b;
    b.set(0, to_f(p[8 * j * LDT]));
    b.set(1, to_f(p[8 * j * LDT + 4]));
    mma<PASSES>(x[j], a, b);
  }
}

// X[16 x 8 NJ] += A[rows 0..15] . B[rows 0..8 NJ-1]^T over columns [0, D) of
// two row-major tiles of pitch LDT (one warp).
template <int PASSES, int NJ, int D, typename T, int LDT>
__device__ __forceinline__ void warp_abt(float (&x)[NJ][4], const T* sA, const T* sB, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    Frag<PASSES, 4> a;
    load_a<PASSES, T, LDT>(a, sA, 8 * kk, g, t);
    mma_bt<PASSES, NJ, T, LDT>(x, a, sB, 8 * kk, g, t);
  }
}

// acc[n] (16 rows x columns n0 + 8n ..) += A . B[rows k0 .. k0+7][n0 + 8n ..],
// with A in the permuted contraction order (slot t = row k0 + 2t, slot t+4 =
// row k0 + 2t + 1 of B).
template <int PASSES, int NACC, typename T, int LDT>
__device__ __forceinline__ void warp_acc(float (&acc)[NACC][4], const Frag<PASSES, 4>& a,
                                         const T* sB, int k0, int n0, int g, int t) {
  const T* r0 = sB + (k0 + 2 * t) * LDT + n0 + g;
#pragma unroll
  for (int n = 0; n < NACC; ++n) {
    Frag<PASSES, 2> b;
    b.set(0, to_f(r0[8 * n]));
    b.set(1, to_f(r0[LDT + 8 * n]));
    mma<PASSES>(acc[n], a, b);
  }
}

// A operand, permuted order, from a C tile held in registers.
template <int PASSES>
__device__ __forceinline__ void a_from_c(Frag<PASSES, 4>& a, const float (&c)[4]) {
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
}

// A operand, permuted order, columns [k0, k0 + 8) of a 16-row f32 buffer of pitch WP.
template <int PASSES, int WP>
__device__ __forceinline__ void a_from_buf(Frag<PASSES, 4>& a, const float* buf, int k0, int g,
                                           int t) {
  const float2 u = *reinterpret_cast<const float2*>(buf + g * WP + k0 + 2 * t);
  const float2 w = *reinterpret_cast<const float2*>(buf + (g + 8) * WP + k0 + 2 * t);
  a.set(0, u.x);
  a.set(1, w.x);
  a.set(2, u.y);
  a.set(3, w.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A warp's accumulator tile (rows r0 + g and r0 + g + 8, columns
// c0 + 8n + 2t, +1) into a [T, D] slice of row stride rs; rows past T drop.
template <typename T, int NACC>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[NACC][4], int r0, int c0,
                                          int T_len, int rs, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T_len) continue;
#pragma unroll
    for (int n = 0; n < NACC; ++n)
      store2(out + (size_t)row * rs + c0 + 8 * n + 2 * t, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// The tile plan of K2 and K3 for one input type and head dim (see the note at
// the top).  BR is the row count of every tile, resident and streamed.
template <typename T, int D> struct BwdPlan {
  static constexpr bool WIDE = D > 128;
  static constexpr int PASSES = sizeof(T) == 4 ? 3 : 1;
  static constexpr int NT = WIDE ? 256 : 128, WARPS = NT / 32;
  static constexpr int BR = WIDE ? 16 : 64;
  static constexpr int WORDS = D * (int)sizeof(T) / 4;          // 32-bit words in a row
  static constexpr int LDT = (WORDS + (12 - WORDS % 8) % 8) * 4 / (int)sizeof(T);   // pitch = 4 mod 8 words
  static constexpr int WP = 24;                                // pitch of the wide score buffers
  static constexpr int NACC = WIDE ? D / (8 * WARPS) : D / 8;  // 8-column accumulator tiles a warp
  static constexpr int PARTS = WARPS / 2, KW = D / 8 / PARTS;  // wide: D parts, k-steps a part
  static constexpr size_t TILE = (size_t)BR * LDT * sizeof(T);
  static constexpr size_t STATS = BR * sizeof(float);
  static constexpr size_t BUF = WIDE ? 2 * PARTS * BR * WP * sizeof(float) : 0;
  // the resident tiles, the ring's two stages, the row statistics, the buffers
  static constexpr size_t kv_smem = 2 * TILE + 2 * (2 * TILE + 2 * STATS) + BUF;
  static constexpr size_t q_smem = 2 * TILE + 2 * 2 * TILE + 2 * STATS + BUF;
  static_assert(D % 8 == 0 && D * sizeof(T) % 16 == 0, "rows must be whole k-steps and chunks");
  static_assert(!WIDE || (NT >= BR * BR && KW * PARTS * 8 == D), "wide plan: a score element a thread");
  static_assert(WIDE || BR == 16 * WARPS, "small plan: 16 rows a warp");
};

// Wide plans: warp w takes one product, X = A1 B1^T (w even) or A2 B2^T
// (w odd), over part w/2 of the D columns (PARTS parts of KW k-steps).  A1
// and A2 are the resident tiles, so the warp splits its A fragments once,
// into registers (128 a thread in f32, 64 in bf16).
template <typename P, int D> struct WideA {
  Frag<P::PASSES, 4> f[P::KW];
  template <typename T>
  __device__ __forceinline__ void load(const T* a1, const T* a2, int warp, int g, int t) {
    const T* a = (warp & 1) ? a2 : a1;
#pragma unroll
    for (int kk = 0; kk < P::KW; ++kk)
      load_a<P::PASSES, T, P::LDT>(f[kk], a, (warp >> 1) * 8 * P::KW + 8 * kk, g, t);
  }
};

// Wide plans, first step: warp w's [16 x 16] partial product into
// buf[w & 1][w >> 1] (pitch WP).  The k-steps go round-robin into two
// partial sums, so that four accumulator chains are in flight, not two.
template <typename P, typename T, int D>
__device__ __forceinline__ void wide_partials(float* buf, const WideA<P, D>& a, const T* b1,
                                              const T* b2, int warp, int g, int t) {
  const int pr = warp & 1, qd = warp >> 1;
  const T* b = pr ? b2 : b1;
  float part[2][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < P::KW; ++kk)
    mma_bt<P::PASSES, 2, T, P::LDT>(part[kk % 2], a.f[kk], b, qd * 8 * P::KW + 8 * kk, g, t);
  float x[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = part[0][j][e] + part[1][j][e];
  float* dst = buf + (pr * P::PARTS + qd) * 16 * P::WP;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    store2(dst + g * P::WP + 8 * j + 2 * t, x[j][0], x[j][1]);
    store2(dst + (g + 8) * P::WP + 8 * j + 2 * t, x[j][2], x[j][3]);
  }
}

// Wide plans, second step, for element (r, c) = (tid / 16, tid % 16): the
// parts of S and of dP summed.
template <typename P>
__device__ __forceinline__ void wide_sum(const float* buf, int r, int c, float& s, float& dp) {
  s = dp = 0.f;
#pragma unroll
  for (int qd = 0; qd < P::PARTS; ++qd) {
    s += buf[qd * 16 * P::WP + r * P::WP + c];
    dp += buf[(P::PARTS + qd) * 16 * P::WP + r * P::WP + c];
  }
}

// ---------------------------------------------------------------------------
// K2: dK, dV.  Grid (ceil(T/BR), B*H); one block per (b*h, BR-row KV tile),
// K and V resident, looping over the Q tiles (Q, dO, lse, delta streamed):
//   S^T = K Q^T; dP^T = V dO^T; P^T = exp(S^T scale - lse);
//   dS^T = P^T (dP^T - delta) scale; dV += P^T dO; dK += dS^T Q.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BwdPlan<T, D>::NT)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int T_len, int H, float scale) {
  using P = BwdPlan<T, D>;
  constexpr int BR = P::BR, LDT = P::LDT, NT = P::NT, PS = P::PASSES;
  constexpr int TE = BR * LDT;   // elements of one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + TE;
  T* ring = sV + TE;                                           // [2 slots][Q, dO]
  float* sStat = reinterpret_cast<float*>(ring + 2 * 2 * TE);  // [2 slots][lse, delta][BR]
  float* sBuf = sStat + 2 * 2 * BR;                            // wide: [S, dP][PARTS][16][WP]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BR, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D, sbase = (size_t)b * T_len * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;

  const int n_tiles = (T_len + BR - 1) / BR;
  // Q tile i (with its lse and delta) into slot i & 1; one commit group
  // each, empty past the last tile, so that the waits below count evenly.
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const int s = i & 1, q0 = i * BR;
      copy_rows<T, D, LDT, BR, NT>(ring + s * 2 * TE, q + base, q0, T_len, rs);
      copy_rows<T, D, LDT, BR, NT>(ring + s * 2 * TE + TE, dout + base, q0, T_len, rs);
      copy_stats<BR, NT>(sStat + s * 2 * BR, lse + sbase, q0, T_len, H);
      copy_stats<BR, NT>(sStat + s * 2 * BR + BR, delta + sbase, q0, T_len, H);
    }
    cp_async_commit();
  };
  copy_rows<T, D, LDT, BR, NT>(sK, k + base, k0, T_len, rs);
  copy_rows<T, D, LDT, BR, NT>(sV, v + base, k0, T_len, rs);
  stage(0);   // the first group carries K and V
  WideA<P, D> afr;
  if constexpr (P::WIDE) {
    cp_async_wait<0>();
    __syncthreads();
    afr.load(sK, sV, warp, g, t);
  }

  float dk_acc[P::NACC][4] = {}, dv_acc[P::NACC][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    stage(i + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int s = i & 1, q0 = i * BR;
    const T* cQ = ring + s * 2 * TE;
    const T* cdO = cQ + TE;
    const float* cL = sStat + s * 2 * BR;
    const float* cD = cL + BR;
    if constexpr (!P::WIDE) {
      // this warp's 16 KV rows x the 64 Q rows, all in registers
      float x[8][4] = {}, y[8][4] = {};
      warp_abt<PS, 8, D, T, LDT>(x, sK + 16 * warp * LDT, cQ, g, t);
      warp_abt<PS, 8, D, T, LDT>(y, sV + 16 * warp * LDT, cdO, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);   // Q row within the tile
          const float p = q0 + c < T_len ? exp2f(x[j][e] * sl2 - cL[c] * kLog2e) : 0.f;
          y[j][e] = p * (y[j][e] - cD[c]) * scale;
          x[j][e] = p;
        }
        Frag<PS, 4> ap, ads;
        a_from_c(ap, x[j]);
        a_from_c(ads, y[j]);
        warp_acc<PS, P::NACC, T, LDT>(dv_acc, ap, cdO, 8 * j, 0, g, t);
        warp_acc<PS, P::NACC, T, LDT>(dk_acc, ads, cQ, 8 * j, 0, g, t);
      }
    } else {
      wide_partials<P, T, D>(sBuf, afr, cQ, cdO, warp, g, t);
      __syncthreads();
      if (threadIdx.x < BR * BR) {
        const int r = threadIdx.x / BR, c = threadIdx.x % BR;   // KV row, Q row
        float sv, dpv;
        wide_sum<P>(sBuf, r, c, sv, dpv);
        const float p = q0 + c < T_len ? exp2f(sv * sl2 - cL[c] * kLog2e) : 0.f;
        sBuf[r * P::WP + c] = p;                                                // P^T
        sBuf[P::PARTS * 16 * P::WP + r * P::WP + c] = p * (dpv - cD[c]) * scale;   // dS^T
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BR / 8; ++kk) {
        Frag<PS, 4> ap, ads;
        a_from_buf<PS, P::WP>(ap, sBuf, 8 * kk, g, t);
        a_from_buf<PS, P::WP>(ads, sBuf + P::PARTS * 16 * P::WP, 8 * kk, g, t);
        warp_acc<PS, P::NACC, T, LDT>(dv_acc, ap, cdO, 8 * kk, 8 * P::NACC * warp, g, t);
        warp_acc<PS, P::NACC, T, LDT>(dk_acc, ads, cQ, 8 * kk, 8 * P::NACC * warp, g, t);
      }
    }
    __syncthreads();   // the stage and the buffers are rewritten next
  }

  const int r0 = k0 + (P::WIDE ? 0 : 16 * warp), c0 = P::WIDE ? 8 * P::NACC * warp : 0;
  store_acc<T, P::NACC>(dk + base, dk_acc, r0, c0, T_len, rs, g, t);
  store_acc<T, P::NACC>(dv + base, dv_acc, r0, c0, T_len, rs, g, t);
}

// ---------------------------------------------------------------------------
// K3: dQ.  Grid (ceil(T/BR), B*H); one block per (b*h, BR-row Q tile), Q,
// dO, lse and delta resident, looping over the KV tiles (K, V streamed):
//   S = Q K^T; dP = dO V^T; dS = exp(S scale - lse) (dP - delta) scale;
//   dQ += dS K.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BwdPlan<T, D>::NT)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int T_len, int H,
                   float scale) {
  using P = BwdPlan<T, D>;
  constexpr int BR = P::BR, LDT = P::LDT, NT = P::NT, PS = P::PASSES;
  constexpr int TE = BR * LDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + TE;
  T* ring = sdO + TE;                                        // [2 slots][K, V]
  float* sLse = reinterpret_cast<float*>(ring + 2 * 2 * TE);
  float* sDelta = sLse + BR;
  float* sBuf = sDelta + BR;                                 // wide: [S, dP][PARTS][16][WP]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BR, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D, sbase = (size_t)b * T_len * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;

  const int n_tiles = (T_len + BR - 1) / BR;
  // KV tile i into slot i & 1; one commit group each (see K2)
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const int s = i & 1, k0 = i * BR;
      copy_rows<T, D, LDT, BR, NT>(ring + s * 2 * TE, k + base, k0, T_len, rs);
      copy_rows<T, D, LDT, BR, NT>(ring + s * 2 * TE + TE, v + base, k0, T_len, rs);
    }
    cp_async_commit();
  };
  copy_rows<T, D, LDT, BR, NT>(sQ, q + base, q0, T_len, rs);
  copy_rows<T, D, LDT, BR, NT>(sdO, dout + base, q0, T_len, rs);
  copy_stats<BR, NT>(sLse, lse + sbase, q0, T_len, H);
  copy_stats<BR, NT>(sDelta, delta + sbase, q0, T_len, H);
  stage(0);   // the first group carries Q, dO, lse, delta
  WideA<P, D> afr;
  if constexpr (P::WIDE) {
    cp_async_wait<0>();
    __syncthreads();
    afr.load(sQ, sdO, warp, g, t);
  }

  float dq_acc[P::NACC][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    stage(i + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int s = i & 1, k0 = i * BR;
    const T* cK = ring + s * 2 * TE;
    const T* cV = cK + TE;
    if constexpr (!P::WIDE) {
      // this warp's 16 Q rows x the 64 KV rows, all in registers
      float x[8][4] = {}, y[8][4] = {};
      warp_abt<PS, 8, D, T, LDT>(x, sQ + 16 * warp * LDT, cK, g, t);
      warp_abt<PS, 8, D, T, LDT>(y, sdO + 16 * warp * LDT, cV, g, t);
      const float l2[2] = {sLse[16 * warp + g] * kLog2e, sLse[16 * warp + g + 8] * kLog2e};
      const float dl[2] = {sDelta[16 * warp + g], sDelta[16 * warp + g + 8]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);   // KV row within the tile
          const float p = k0 + c < T_len ? exp2f(x[j][e] * sl2 - l2[e >> 1]) : 0.f;
          y[j][e] = p * (y[j][e] - dl[e >> 1]) * scale;
        }
        Frag<PS, 4> ads;
        a_from_c(ads, y[j]);
        warp_acc<PS, P::NACC, T, LDT>(dq_acc, ads, cK, 8 * j, 0, g, t);
      }
    } else {
      wide_partials<P, T, D>(sBuf, afr, cK, cV, warp, g, t);
      __syncthreads();
      if (threadIdx.x < BR * BR) {
        const int r = threadIdx.x / BR, c = threadIdx.x % BR;   // Q row, KV row
        float sv, dpv;
        wide_sum<P>(sBuf, r, c, sv, dpv);
        const float p = k0 + c < T_len ? exp2f(sv * sl2 - sLse[r] * kLog2e) : 0.f;
        sBuf[r * P::WP + c] = p * (dpv - sDelta[r]) * scale;   // dS
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BR / 8; ++kk) {
        Frag<PS, 4> ads;
        a_from_buf<PS, P::WP>(ads, sBuf, 8 * kk, g, t);
        warp_acc<PS, P::NACC, T, LDT>(dq_acc, ads, cK, 8 * kk, 8 * P::NACC * warp, g, t);
      }
    }
    __syncthreads();   // the stage and the buffers are rewritten next
  }

  const int r0 = q0 + (P::WIDE ? 0 : 16 * warp), c0 = P::WIDE ? 8 * P::NACC * warp : 0;
  store_acc<T, P::NACC>(dq + base, dq_acc, r0, c0, T_len, rs, g, t);
}

// K1's tile plan.  Small heads: 64x64 tiles, 128 threads.  D = 512: see the
// note at the top (shared memory caps the tiles at 32 rows).
template <int D> struct Plan {
  static constexpr int NT = 128, TXS = 16, TXO = 8;
  static constexpr int FWD_BQ = 64, FWD_BK = 64;
};
template <> struct Plan<512> {
  static constexpr int NT = 256, TXS = 16, TXO = 32;
  static constexpr int FWD_BQ = 32, FWD_BK = 32;
};

constexpr size_t fwd_smem(int D, int BQ, int BK) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1) + 2 * BQ);
}

template <typename KernelFn>
cudaError_t allow_smem(KernelFn fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// cp.async moves 16-byte chunks: the [B, T, H, D] tensors must start on a
// 16-byte boundary (rows are whole chunks for every compiled head dim).
bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
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
  using P = BwdPlan<T, D>;
  if (misaligned({q, k, v, dout, dk, dv})) return (int)cudaErrorMisalignedAddress;
  auto fn = flash_bwd_kv_kernel<T, D>;
  cudaError_t err = allow_smem(fn, P::kv_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + P::BR - 1) / P::BR, B * H);
  fn<<<grid, P::NT, P::kv_smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                           (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                                           T_len, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_q_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int T_len, int H, float scale,
                 cudaStream_t stream) {
  using P = BwdPlan<T, D>;
  if (misaligned({q, k, v, dout, dq})) return (int)cudaErrorMisalignedAddress;
  auto fn = flash_bwd_q_kernel<T, D>;
  cudaError_t err = allow_smem(fn, P::q_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + P::BR - 1) / P::BR, B * H);
  fn<<<grid, P::NT, P::q_smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
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
