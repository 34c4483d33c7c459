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
// All three kernels run their products -- S = QK^T and O += P V in K1;
// S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K in K2 and
// K3 -- on the tensor cores with mma.sync.m16n8k8 in TF32, so they are bound
// by operations at the tensor cores' TF32 rate.
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
//  - The backward in two kernels, no atomics: K2 owns a KV tile and loops
//    over the Q tiles, K3 (like K1) owns a Q tile and loops over the KV
//    tiles, as the TPU grid's sequential axis did, so results are the same
//    from run to run.
//  - The streamed tiles (K, V in K1 and K3; Q, dO, lse, delta in K2) arrive
//    by cp.async (16 bytes, .cg) in a two-stage ring, so the next tile's
//    load overlaps this tile's products; rows past T are zero-filled with a
//    source size of 0.  Row pitches are padded to W 32-bit words with
//    W = 4 mod 8, which makes every fragment load below free of bank
//    conflicts (row-major walks hit banks g*W + t, row walks 2t*W + g).
//  - A C tile reused as the next product's A operand stays in registers: a
//    product's contraction order is free, so k-slot t stands for column 2t
//    and slot t+4 for column 2t+1, and the B operand is read from rows 2t,
//    2t+1 to match.
//
// K1's tile plans (FwdPlan), reckoned from shared memory (227 KB a block)
// and registers (65,536 an SM, 255 a thread).  The Q tile arrives in a ring
// slot and goes to registers as A fragments split once (hi and lo), so its
// shared memory joins the ring; the online softmax keeps an f32 running max
// m (base 2) and each lane's part of the row sum l, rescales the O
// accumulator in registers by corr = exp(m_prev - m_new), and adds P V.
//  - D <= 80: 64-row Q tiles, 4 warps of 16 rows (flash-2), 64-row K and V
//    tiles.  S [16 x 64] is 8 C tiles a warp; a row's max and sum are two
//    shuffles over its 4 lanes; P goes to P V's A operand in registers.
//    f32 D = 40: 44 KB of shared memory (the ring), 168 registers, 3 blocks
//    an SM; grid 64 x 16 = 1024 blocks at [2, 4096, 8, 40].
//  - D = 512: every block streams all of K and V through L2 (16.8 MB a
//    block in f32), so the resident Q tile is 32 rows, twice K2/K3's 16,
//    which halves that traffic and still gives 128 blocks at B*H = 1.  16
//    warps (512 threads, 128 registers at most), 16-row K and V tiles.
//    S [32 x 16]: warp w takes Q half w % 2 and an eighth of D (8 k-steps,
//    its A fragments in 64 registers) and writes its partial tile to shared
//    memory; after a barrier each thread sums the 8 parts of one score
//    element and updates its row's statistics (16 lanes); after another,
//    warp w adds P V to O rows of its half, D columns [64 (w / 2), +64)
//    (32 accumulator registers).  f32: the ring's two stages (132 KB) and
//    the partial scores (24 KB), one block an SM; 128 registers, no spills.
//
// K2/K3's tile plans (BwdPlan):
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
// What holds the D = 512 plans back (H100, f32, B*H = 8): each block reads
// every streamed row for 16 (K2, K3) or 32 (K1) resident rows, and those
// copies and the products slow each other; without the copies K2 and K3
// take two thirds to three quarters of their time, with half the rows
// copied 85 %.  K1 takes 79 % of its time without the copies, when its
// products run at about half the mma.sync 3xTF32 ceiling, and the copies
// alone (17.2 GB read through L2) take 63 %.
// Later work: sharing the streamed tiles between the blocks of a cluster
// (TMA multicast), and wgmma and TMA for the bf16 path.

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

// ---------------------------------------------------------------------------
// Tensor-core building blocks of K1, K2 and K3.
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

// Row pitch, in elements of T, of a tile of D columns in shared memory: the
// row's 32-bit words padded to 4 mod 8.
template <typename T> constexpr int row_pitch(int D) {
  return (D * (int)sizeof(T) / 4 + (12 - D * (int)sizeof(T) / 4 % 8) % 8) * 4 / (int)sizeof(T);
}

// ---------------------------------------------------------------------------
// K1: forward.  Grid (ceil(T/BQ), B*H); one block per (b*h, BQ-row Q tile),
// looping over the KV tiles (the TPU grid's sequential axis):
//   S = Q K^T; m' = max(m, rowmax S scale); corr = exp(m - m');
//   P = exp(S scale - m'); l = l corr + rowsum P; O = O corr + P V;
// at the end o = O / l and lse = m + log l.  The exponentials run in base 2
// on S scale log2(e), so m is kept in base-2 units.
// ---------------------------------------------------------------------------

// K1's tile plan for one input type and head dim (see the note at the top).
// Warp w takes the 16 Q rows of group w % RG and part w / RG of D (KW
// k-steps of S, NACC 8-column tiles of O).
template <typename T, int D> struct FwdPlan {
  static constexpr bool WIDE = D > 128;
  static constexpr int PASSES = sizeof(T) == 4 ? 3 : 1;
  static constexpr int NT = WIDE ? 512 : 128, WARPS = NT / 32;
  static constexpr int BQ = WIDE ? 32 : 64, BK = WIDE ? 16 : 64;   // Q rows, streamed KV rows
  static constexpr int LDT = row_pitch<T>(D);
  static constexpr int WP = 24;                                    // pitch of the wide score buffer
  static constexpr int RG = BQ / 16, PARTS = WARPS / RG;          // row groups, parts of D
  static constexpr int KW = D / 8 / PARTS;                         // k-steps of a warp's S
  static constexpr int NACC = D / 8 / PARTS;                       // 8-column O tiles a warp
  static constexpr size_t STAGE = 2 * (size_t)BK * LDT * sizeof(T);   // a ring slot: K and V
  static constexpr size_t BUF = WIDE ? (size_t)PARTS * BQ * WP * sizeof(float) : 0;
  static constexpr size_t ROWS = WIDE ? 2 * BQ * sizeof(float) : 0;   // wide: corr, 1 / l
  static constexpr size_t smem = 2 * STAGE + BUF + ROWS;            // a two-stage ring
  static_assert(D % 8 == 0 && D * sizeof(T) % 16 == 0, "rows must be whole k-steps and chunks");
  static_assert((size_t)BQ * LDT * sizeof(T) <= STAGE, "the Q tile arrives in a ring slot");
  static_assert(RG * 16 == BQ && PARTS * RG == WARPS && PARTS * KW * 8 == D,
                "the warps cover Q's rows and D");
  static_assert(WIDE ? (BK == 16 && NT == BQ * BK) : (PARTS == 1 && BK == 64),
                "wide: a score element a thread; small: a warp's rows x 8 S tiles");
};

// Running row statistics and output accumulator of one thread.  Small plan:
// the lane's rows g and g + 8 of its warp's 16 (m[r], l[r]).  Wide plan:
// score element (tid / 16, tid % 16), its row's m[0], l[0].  l is this
// thread's part of the row sum; the row's lanes add theirs at the end (each
// rescale multiplies all of them by the same corr).
template <typename P> struct FwdState {
  float acc[P::NACC][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
};

template <typename P> using QFrags = Frag<P::PASSES, 4>[P::KW];

// Small plan, one KV tile: this warp's 16 Q rows x the 64 KV rows, all in
// registers.  S's C tiles become P's A operands (permuted order).
template <typename P, typename T>
__device__ __forceinline__ void fwd_small_tile(FwdState<P>& st, const QFrags<P>& qa, const T* cK,
                                               const T* cV, int k0, int T_len, float sl2, int g,
                                               int t) {
  constexpr int PS = P::PASSES, LDT = P::LDT;
  float s[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < P::KW; ++kk) mma_bt<PS, 8, T, LDT>(s, qa[kk], cK, 8 * kk, g, t);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);   // KV row within the tile
      s[j][e] = k0 + c < T_len ? s[j][e] * sl2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(st.m[r], group_max<4>(mx[r]));   // finite: column k0 is valid
    corr[r] = exp2f(st.m[r] - mn);                            // 0 at the first tile
    st.m[r] = mn;
    st.l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < P::NACC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] *= corr[e >> 1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - st.m[e >> 1]);
      st.l[e >> 1] += s[j][e];
    }
    Frag<PS, 4> ap;
    a_from_c(ap, s[j]);
    warp_acc<PS, P::NACC, T, LDT>(st.acc, ap, cV, 8 * j, 0, g, t);
  }
}

// Wide plan, one KV tile, in three steps between barriers:
//  1. warp w: its 16 Q rows times the 16 KV rows over its part of D, into
//     sBuf[part] (pitch WP), from the Q fragments in registers;
//  2. thread (r, c): the parts of S[r][c] summed, the row's statistics
//     (16 lanes), P[r][c] into sBuf[0], the row's corr into sRow[r];
//  3. warp w: O[its rows][its columns] = O corr + P V.
template <typename P, typename T>
__device__ __forceinline__ void fwd_wide_tile(FwdState<P>& st, const QFrags<P>& qa, const T* cK,
                                              const T* cV, float* sBuf, float* sRow, int k0,
                                              int T_len, float sl2, int rg, int part, int g,
                                              int t) {
  constexpr int PS = P::PASSES, LDT = P::LDT, WP = P::WP, BQ = P::BQ;
  float x[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < P::KW; ++kk)
    mma_bt<PS, 2, T, LDT>(x, qa[kk], cK, 8 * (part * P::KW + kk), g, t);
  float* dst = sBuf + (part * BQ + 16 * rg) * WP;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    store2(dst + g * WP + 8 * j + 2 * t, x[j][0], x[j][1]);
    store2(dst + (g + 8) * WP + 8 * j + 2 * t, x[j][2], x[j][3]);
  }
  __syncthreads();
  {
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    float sv = 0.f;
#pragma unroll
    for (int qd = 0; qd < P::PARTS; ++qd) sv += sBuf[(qd * BQ + r) * WP + c];
    const float xv = k0 + c < T_len ? sv * sl2 : -INFINITY;
    const float mn = fmaxf(st.m[0], group_max<16>(xv));   // finite: column k0 is valid
    const float corr = exp2f(st.m[0] - mn);                 // 0 at the first tile
    const float p = exp2f(xv - mn);
    st.l[0] = st.l[0] * corr + p;
    st.m[0] = mn;
    sBuf[r * WP + c] = p;
    if (c == 0) sRow[r] = corr;
  }
  __syncthreads();
  const float c0 = sRow[16 * rg + g], c1 = sRow[16 * rg + g + 8];
#pragma unroll
  for (int n = 0; n < P::NACC; ++n) {
    st.acc[n][0] *= c0;
    st.acc[n][1] *= c0;
    st.acc[n][2] *= c1;
    st.acc[n][3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < P::BK / 8; ++kk) {
    Frag<PS, 4> ap;
    a_from_buf<PS, WP>(ap, sBuf + 16 * rg * WP, 8 * kk, g, t);
    warp_acc<PS, P::NACC, T, LDT>(st.acc, ap, cV, 8 * kk, 8 * P::NACC * part, g, t);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FwdPlan<T, D>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_len, int H, float scale) {
  using P = FwdPlan<T, D>;
  constexpr int BQ = P::BQ, BK = P::BK, LDT = P::LDT, NT = P::NT;
  constexpr int TE = BK * LDT;   // elements of one K or V tile
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                    // [2 slots][K, V]
  float* sBuf = reinterpret_cast<float*>(ring + 2 * 2 * TE);   // wide: [PARTS][BQ][WP]
  float* sRow = sBuf + P::BUF / sizeof(float);                  // wide: [corr, 1 / l][BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp % P::RG, part = warp / P::RG;   // this warp's Q rows and part of D
  const float sl2 = scale * kLog2e;

  const int n_tiles = (T_len + BK - 1) / BK;
  // KV tile i into slot i & 1, one commit group each.
  auto stage = [&](int i) {
    if (i < n_tiles) {
      T* s = ring + (i & 1) * 2 * TE;
      copy_rows<T, D, LDT, BK, NT>(s, k + base, i * BK, T_len, rs);
      copy_rows<T, D, LDT, BK, NT>(s + TE, v + base, i * BK, T_len, rs);
    }
    cp_async_commit();
  };
  // The Q tile arrives in slot 1, with tile 0, and goes to registers as A
  // fragments split once; slot 1 then takes tile 1.
  T* sQ = ring + 2 * TE;
  copy_rows<T, D, LDT, BQ, NT>(sQ, q + base, q0, T_len, rs);
  stage(0);
  cp_async_wait<0>();
  __syncthreads();
  QFrags<P> qa;
#pragma unroll
  for (int kk = 0; kk < P::KW; ++kk)
    load_a<P::PASSES, T, LDT>(qa[kk], sQ + 16 * rg * LDT, 8 * (part * P::KW + kk), g, t);

  FwdState<P> st;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i is here; every warp is done with tile i - 1 (or Q)
    stage(i + 1);      // into the slot of tile i - 1, while tile i is computed
    const T* cK = ring + (i & 1) * 2 * TE;
    if constexpr (P::WIDE) {
      fwd_wide_tile<P, T>(st, qa, cK, cK + TE, sBuf, sRow, i * BK, T_len, sl2, rg, part, g, t);
    } else {
      fwd_small_tile<P, T>(st, qa, cK, cK + TE, i * BK, T_len, sl2, g, t);
    }
  }

  const size_t sbase = (size_t)b * T_len * H + h;
  float inv[2];
  if constexpr (P::WIDE) {
    const int r = threadIdx.x >> 4;
    const float l = group_sum<16>(st.l[0]);
    if ((threadIdx.x & 15) == 0) {
      sRow[BQ + r] = 1.f / l;
      if (q0 + r < T_len) lse[sbase + (size_t)(q0 + r) * H] = st.m[0] * kLn2 + logf(l);
    }
    __syncthreads();
    inv[0] = sRow[BQ + 16 * rg + g];
    inv[1] = sRow[BQ + 16 * rg + g + 8];
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = group_sum<4>(st.l[r]);
      const int row = q0 + 16 * rg + g + 8 * r;
      if (t == 0 && row < T_len) lse[sbase + (size_t)row * H] = st.m[r] * kLn2 + logf(l);
      inv[r] = 1.f / l;
    }
  }
#pragma unroll
  for (int n = 0; n < P::NACC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] *= inv[e >> 1];
  store_acc<T, P::NACC>(o + base, st.acc, q0 + 16 * rg, 8 * P::NACC * part, T_len, rs, g, t);
}

// The tile plan of K2 and K3 for one input type and head dim (see the note at
// the top).  BR is the row count of every tile, resident and streamed.
template <typename T, int D> struct BwdPlan {
  static constexpr bool WIDE = D > 128;
  static constexpr int PASSES = sizeof(T) == 4 ? 3 : 1;
  static constexpr int NT = WIDE ? 256 : 128, WARPS = NT / 32;
  static constexpr int BR = WIDE ? 16 : 64;
  static constexpr int LDT = row_pitch<T>(D);
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
  using P = FwdPlan<T, D>;
  if (misaligned({q, k, v, o})) return (int)cudaErrorMisalignedAddress;
  auto fn = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(fn, P::smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + P::BQ - 1) / P::BQ, B * H);
  fn<<<grid, P::NT, P::smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
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
