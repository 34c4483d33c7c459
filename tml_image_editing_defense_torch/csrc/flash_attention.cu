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
// K1, K2 and K3 in f32 run their products -- S = QK^T and O += P V in
// K1; S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K in K2
// and K3 -- on the tensor cores with mma.sync.m16n8k8 in TF32, so they are
// bound by operations at the tensor cores' TF32 rate.  In bf16 all three
// run them on wgmma at bf16's rate instead (below), but for K2 at D = 512.
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
//  - bf16 inputs to these plans (K2 at D = 512, K1 at D = 512 under one
//    wave of blocks): a bf16 value is exact in
//    TF32, so one pass; P and dS round to TF32's 10 mantissa bits, finer
//    than the bf16 output's 8.  The pass count is a compile-time parameter
//    of one code path.
//  - mma.sync, not wgmma, in f32: wgmma takes TF32 operands only K-major,
//    and three of the five products contract over a tile's rows (P^T dO,
//    dS^T Q, dS K).  mma.sync loads each fragment from shared memory in
//    whichever orientation the tile sits.  Its ceiling on an H100 is about
//    320 TFLOP/s in TF32 (two thirds of wgmma's), 107 in 3xTF32.  A 16-bit
//    wgmma operand may be K-major or MN-major, so the bf16 K2 and K3 use it.
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
// K1's f32 tile plans (FwdPlan), reckoned from shared memory (227 KB a block)
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
// K2/K3's f32 plans (BwdPlan; also K2's bf16 plan at D = 512):
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
//
// K2/K3's bf16 plans (WgPlan), on wgmma.mma_async bf16 -> f32.  P and dS
// are computed in f32 and rounded to bf16 only as the A operand of the next
// product, where the Pallas kernels round them; accumulators are f32 and the
// outputs are rounded once.  Tiles sit in shared memory chunk-column by
// chunk-column (16 bytes of eight rows' columns, then the next chunk), no
// swizzle: eight rows of a chunk are one wgmma core matrix, so one tile is
// a K-major operand (S = Q K^T) and an MN-major one (dV += P^T dO) alike.
//  - D <= 80: a block of three warpgroups.  Two consumers each own 64 of
//    the 128 resident rows (K2: K and V; K3: Q and dO; the 64 x 64 score
//    tile of a streamed tile in 32 + 32 accumulator registers a thread) and
//    one producer warp keeps the streamed 64-row tiles (K2: Q, dO and their
//    lse, delta; K3: K, V) coming by TMA into a four-stage ring of
//    mbarriers (full: the tile's bytes and, in K2, the 32 lanes' statistics;
//    empty: the 8 consumer warps), so the consumers issue no copies and
//    never wait on each other.  A TMA map over [B, T, H, D] with a box of
//    8 columns x rows fills one chunk column (CH boxes a tile) and reads
//    rows past T as zeros; D = 40 pads its third k-step with a chunk of
//    zeros the block writes once.  S^T = K Q^T and dP^T = V dO^T (K2; S, dP
//    in K3) run with the resident rows as A from registers (loaded once;
//    K2 at D = 80 reads K and V from shared memory: its registers run out),
//    the streamed tile K-major as B, m64n64k16, ceil(D / 16) k-steps; P and
//    dS go from the accumulator to bf16 A fragments in registers and the
//    gradient products take the streamed tile MN-major, m64nDk16, four
//    k-steps.  A tile's gradient products run on while the next tile's
//    scores are issued (its ring slot is released once they are done);
//    2^x is ex2.approx.ftz.  K2 needs no mask: a Q row past T arrives as
//    zeros with lse = delta = 0 (P = 1 meets a zero dO row, dS = 0); K3
//    masks the KV rows past T, whose P = 2^-lse could overflow.
//    setmaxnreg moves registers from the producer (40) to the consumers
//    (232 a thread; the block starts at 168).  Shared
//    memory: 75, 99 and 123 KB at D = 40, 64, 80; one block an SM; grid
//    ceil(T / 128) x B*H (640 blocks at [2, 4096, 10, 64]).
//  - D = 512 (K3): four warpgroups share 64 resident Q rows, warpgroup w
//    D columns [128 w, 128 w + 128); a 64-row tile is 64 KB, so the streamed
//    K and V tiles are 16 rows, copied by cp.async into a two-stage ring.
//    Each warpgroup takes its part of S and dP over its columns
//    (m64n16k16, A and B from shared memory, 8 k-steps) and the four parts
//    are summed through shared memory in a fixed order (32 KB); dQ += dS K
//    is one m64n128k16 a warpgroup.  225 KB of shared memory, 117 registers.
//  - D = 512 (K2) keeps the mma.sync plan: a wgmma plan holding dK and dV
//    for 64 KV rows (256 KB of f32, the whole register file) had to split
//    them between two blocks, which both recompute S^T, and re-read its
//    64-row K and V tiles from shared memory for every 16-row Q tile; it
//    took 7.1-7.4 ms at [8, 4096, 1, 512] against this plan's 6.1-6.3
//    (NVIDIA H100 80GB HBM3, 700 W; scripts/probe_flash_cuda.py --bf16).
//
// K1's bf16 plans (FwdWgPlan), on wgmma bf16 -> f32 with the pieces of K2/K3's
// (the chunk-column layout, the TMA ring, setmaxnreg).  As the Pallas
// _fwd_kernel: S in f32, the online softmax's running max and sum in f32, P
// rounded to bf16 only as P V's A operand, an f32 accumulator, o rounded
// once, lse = m + log l.  The softmax runs in base 2 on the accumulator
// layout (the row's max and sum over its 4 lanes by shuffles, 2^x by
// ex2.approx.ftz), and O is rescaled in registers.
//  - D <= 80 (flash_fwd_kernel_tma): a block of three warpgroups.  Two
//    consumers each own 64 of the block's 128 Q rows, loaded once by TMA and
//    held as A fragments in registers; the producer warp keeps 64-row K and
//    V tiles coming by TMA into a four-stage mbarrier ring.  S = Q K^T is
//    m64n64k16 with K K-major, ceil(D / 16) k-steps (D = 40 pads its third
//    with a zero chunk); P goes from the accumulator to bf16 A fragments in
//    registers and O += P V is m64nDk16 with V MN-major, four k-steps.  The
//    next tile's S is issued before this tile's P V, so the softmax of one
//    tile runs while the other's products do; a slot is released once its
//    P V is done.  KV rows past T are masked; Q rows past T arrive as zeros
//    and are not written.  Shared memory: 60, 80 and 100 KB at D = 40, 64,
//    80; one block an SM; grid ceil(T / 128) x B*H (640 blocks at
//    [2, 4096, 10, 64]).
//  - D = 512 (flash_fwd_kernel_wide): four warpgroups share 64 Q rows,
//    resident in shared memory; warpgroup w holds O's columns [128 w,
//    128 w + 128) in f32 (64 registers a thread) and computes S over its
//    part of D (m64n32k16, A and B from shared memory, 8 k-steps); the four
//    parts are summed through shared memory in a fixed order, so every
//    warpgroup runs the same softmax on the same sums and adds its columns
//    of P V (m64n128k16, P from registers, two k-steps).  K and V tiles of
//    32 rows (a 16-row tile would make the score products read twice the
//    bytes of shared memory for each product) arrive by cp.async in a
//    two-stage ring: 64 KB of Q, 128 KB of ring, 32 KB of parts.  Where the
//    64-row blocks would not fill the card once (B*H*ceil(T / 64) under the
//    SM count, as at [1, 4096, 1, 512]), the launcher takes the f32 plans'
//    32-row mma.sync plan in one TF32 pass instead (fwd_wide_plan).
// Later work: sharing the streamed tiles between the blocks of a cluster
// (TMA multicast).

#include <cuda.h>   // CUtensorMap; its encoder is reached through the runtime, no -lcuda
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

// ---------------------------------------------------------------------------
// bf16 K2 and K3 on wgmma (sm_90a); see the note at the top for the plans.
//
// Shared-memory tiles of these plans hold R rows of 16-byte chunks (eight
// bf16 columns each) chunk-column by chunk-column: chunk c of row r at byte
// 16 (c R + r).  Eight consecutive rows of one chunk are one wgmma core
// matrix (8 x 16 bytes, contiguous), so one tile, without swizzle, is an
// operand K-major (contracted over its columns: S = Q K^T) and MN-major
// (contracted over its rows: dV += P^T dO) alike.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma matrix descriptor without swizzle: start address, leading-dimension
// byte offset (between core matrices along the contraction) and
// stride-dimension byte offset (between core matrices along M or N), each
// in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | (uint64_t)((lbo >> 4) & 0x3fffu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fffu) << 32;
}

// K-major operand: rows [r0, r0 + 8 n) of a tile of R rows, k-step ks
// (chunks 2 ks and 2 ks + 1).
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int ks) {
  return gmma_desc(smem_addr(tile) + (2 * ks * R + r0) * 16, R * 16, 128);
}

// MN-major operand: rows [16 ks, 16 ks + 16) of a tile of R rows as the
// contraction, its chunks from c0 on as N.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int c0, int ks) {
  return gmma_desc(smem_addr(tile) + (c0 * R + 16 * ks) * 16, 128, R * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders every later read of an accumulator after the wait above it.
template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Makes this thread's finished cp.async and st.shared writes visible to
// wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// p, hidden from the compiler anew at each use: the descriptors made from it
// inside a loop are then not kept live across the loop, one per k-step.
template <typename T> __device__ __forceinline__ T* launder(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.m64nNk16, bf16 operands, f32 accumulators: D = A B + D, or D = A B
// where scale_d is 0 (so that no instruction but a wgmma writes an
// accumulator, which would make ptxas serialize the pipeline).  The
// accumulator of a [64 x N] product: warp w of the warpgroup holds rows
// 16 w + g and 16 w + g + 8; d[4 n + e] is (row 16 w + g + 8 (e >> 1),
// column 8 n + 2 t + (e & 1)), lane = 4 g + t.

// D[64 x 16] += A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 32] += A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x N] += A B, A from registers (a bf16 A fragment), B in shared memory,
// K-major (TB = 0) or MN-major (TB = 1).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[20], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// A fragment of k-step j (columns 16 j .. 16 j + 15) of a [64 x N]
// accumulator, rounded to bf16: the layout of wgmma's A in registers.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[N], int j) {
  a[0] = pack_bf16(x[8 * j], x[8 * j + 1]);
  a[1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
  a[2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
  a[3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
}

// A fragments of k-steps [0, KS) for the 16 rows from r0 (this warp's part of
// a warpgroup's 64) of a chunk-column tile of R rows: a[ks] holds rows
// r0 + g, r0 + g + 8 and columns 16 ks + 2 t, + 1 and 16 ks + 8 + 2 t, + 1.
template <int R, int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* tile, int r0, int g,
                                       int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* c0 = tile + ((2 * ks) * R + r0 + g) * 8 + 2 * t;   // chunk 2 ks
    const bf16* c1 = c0 + R * 8;                                   // chunk 2 ks + 1
    a[ks][0] = *reinterpret_cast<const uint32_t*>(c0);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(c0 + 64);          // 8 rows on
    a[ks][2] = *reinterpret_cast<const uint32_t*>(c1);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(c1 + 64);
  }
}

// R rows of one (b, h) slice, from row0, into a chunk-column tile of R rows
// by 16-byte cp.async; rows at or past T are zero-filled.  Eight
// neighbouring threads copy one chunk of eight rows (128 contiguous bytes of
// shared memory), the next eight the next chunk of the same rows, so a warp
// reads 64 contiguous bytes of each of eight rows.
template <int D, int R, int NT>
__device__ __forceinline__ void copy_tile(bf16* s, const bf16* g, int row0, int T_len, int rs) {
  constexpr int CH = D / 8, N = R * CH;
  static_assert(R % 8 == 0, "whole core matrices");
#pragma unroll
  for (int j = 0; j < (N + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (N % NT != 0 && i >= N) break;
    const int u = i >> 3, c = u % CH, r = (u / CH) * 8 + (i & 7), t = row0 + r;
    const bool ok = t < T_len;
    cp_async_16(s + (c * R + r) * 8, g + (size_t)(ok ? t : 0) * rs + c * 8, ok);
  }
}

// Chunk c of every row of a chunk-column tile of R rows, set to zero.
template <int R, int NT>
__device__ __forceinline__ void zero_chunk(bf16* s, int c) {
  for (int r = threadIdx.x; r < R; r += NT)
    *reinterpret_cast<uint4*>(s + (c * R + r) * 8) = make_uint4(0u, 0u, 0u, 0u);
}

// A warpgroup's [64 x N] accumulator (rows r0 + 16 w + g, + 8; columns
// c0 + 8 n + 2 t, + 1) into a [T, D] slice of row stride rs, rounded once to
// bf16; rows past T drop.
template <int N>
__device__ __forceinline__ void store_frag(bf16* out, const float (&acc)[N], int r0, int c0,
                                           int T_len, int rs, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T_len) continue;
#pragma unroll
    for (int n = 0; n < N / 4; ++n)
      store2(out + (size_t)row * rs + c0 + 8 * n + 2 * t, acc[4 * n + 2 * half],
             acc[4 * n + 2 * half + 1]);
  }
}

// The bf16 plans of K2 and K3 for head dim D (see the note at the top).
template <int D, bool AREG_ = true> struct WgPlan {
  static constexpr bool WIDE = D > 128;
  static constexpr int NWG = WIDE ? 4 : 2;                // consumer warpgroups
  static constexpr int NT = 128 * NWG;                    // their threads
  static constexpr int NTB = NT + (WIDE ? 0 : 128);       // small: and a producer warpgroup
  static constexpr int RES = WIDE ? 64 : 64 * NWG;        // resident rows
  static constexpr int BS = WIDE ? 16 : 64;               // streamed rows a tile
  // small plans: the resident tiles' A fragments of the score products held
  // in registers, loaded once, rather than read from shared memory each tile
  static constexpr bool AREG = AREG_ && !WIDE;
  static constexpr int STAGES = WIDE ? 2 : 4;             // the ring's stages
  static constexpr int CH = D / 8, KS = (CH + 1) / 2;     // chunks of a row, k-steps over D
  static constexpr int CP = 2 * KS;                       // chunk columns kept (D = 40: one zero)
  static constexpr int DW = WIDE ? D / NWG : D;           // gradient columns a warpgroup
  static constexpr int KW = WIDE ? DW / 16 : KS;          // k-steps of a warpgroup's scores
  static constexpr int NS = BS / 2, ND = DW / 2;          // accumulator registers: scores, gradient
  static constexpr int RES_TILE = RES * CP * 16, ST_TILE = BS * CP * 16;   // bytes
  static constexpr int STAGE = 2 * ST_TILE + 2 * BS * 4;  // two tiles and (K2) lse, delta
  static constexpr int RSTAT = WIDE ? 2 * RES * 4 : 0;    // wide K3: the resident lse, delta
  static constexpr int PART = WIDE ? NWG * 2 * 128 * NS * 4 : 0;   // wide: partial scores
  static constexpr int BARS = WIDE ? 0 : 8 * (2 * STAGES + 1);     // small: the ring's mbarriers
  static constexpr size_t smem =
      2 * (size_t)RES_TILE + STAGES * (size_t)STAGE + RSTAT + PART + BARS;
  static_assert(D % 8 == 0 && (WIDE ? DW % 16 == 0 : DW <= 256), "whole chunks and k-steps");
  static_assert(RES <= NT && BS <= NT && RES <= 256 && BS <= 256, "row statistics; TMA boxes");
  static_assert(smem <= 232448, "a block's shared memory");
};

// K2 at D = 80 keeps K and V in shared memory: their A fragments would take
// the consumers past their 232 registers
template <int D> using KvPlan = WgPlan<D, (D <= 64)>;   // K2's
template <int D> using QPlan = WgPlan<D>;               // K3's

// 2^x on the special-function unit, subnormal results flushed to zero (P
// rounds to bf16, whose smallest normal is 2^-126, for a product at once).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- the small plans' copies: TMA into an mbarrier ring ---------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One arrival, and `bytes` more for the phase to wait for from TMA.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Until the phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Chunk column c (8 columns) of `rows` rows of one (b, h), from row t0, by
// TMA into shared memory (16 rows' bytes a row: the chunk-column layout);
// rows at or past T arrive as zeros.  The map's box is 8 x 1 x rows x 1.
__device__ __forceinline__ void tma_chunk(bf16* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                          int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(8 * c), "r"(h), "r"(t0), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// A warpgroup's register budget a thread, moved at run time: the block starts
// with 168 (65,536 over three warpgroups); the producer drops to 40 and the
// two consumer warpgroups rise to 232 (2 x 232 + 40 = 504 of 512).
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The ring of a small plan: STAGES slots, each with a full barrier (its tiles
// and statistics are here) and an empty barrier (every consumer warp is done
// with it), and the barrier of the resident tiles.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res;
};

// Set up by thread 0; the block then synchronises before any use.
template <int STAGES>
__device__ __forceinline__ Ring ring_init(unsigned char* at, uint32_t full_count,
                                          uint32_t consumer_warps) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(at);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + s, full_count);
      mbar_init(bars + STAGES + s, consumer_warps);
    }
    mbar_init(bars + 2 * STAGES, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return Ring{bars, bars + STAGES, bars + 2 * STAGES};
}

// ---------------------------------------------------------------------------
// K2 in bf16, small plan (D <= 80): dK, dV.  Grid (ceil(T/RES), B*H); one
// block per (b*h, RES-row KV tile): two consumer warpgroups, warpgroup w on
// KV rows [64 w, 64 w + 64), and a producer warp that keeps the Q and dO
// tiles (TMA) and their lse and delta (loads) of the next tiles in the ring.
//   S^T = K Q^T; dP^T = V dO^T; P^T = exp(S^T scale - lse);
//   dS^T = P^T (dP^T - delta) scale; dV += P^T dO; dK += dS^T Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(KvPlan<D>::NTB, 1)
flash_bwd_kv_kernel_tma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int H,
                        float scale) {
  using P = KvPlan<D>;
  constexpr int RES = P::RES, BS = P::BS, NT = P::NT, NS = P::NS, ST = P::STAGES;
  extern __shared__ __align__(128) unsigned char smem_tma[];   // TMA: 128-byte aligned
  bf16* sK = reinterpret_cast<bf16*>(smem_tma);
  bf16* sV = sK + RES * P::CP * 8;
  unsigned char* ring = smem_tma + 2 * P::RES_TILE;   // [STAGES][Q, dO, lse, delta]
  const Ring bar = ring_init<ST>(ring + ST * P::STAGE, 1 + 32, NT / 32);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * RES;
  const size_t sbase = (size_t)b * T_len * H + h;
  const int n_tiles = (T_len + BS - 1) / BS;
  auto slot = [&](int i) { return ring + (i % ST) * P::STAGE; };
  if constexpr (P::CP != P::CH) {   // the zero chunk that pads D to whole k-steps
    zero_chunk<RES, P::NTB>(sK, P::CH);
    zero_chunk<RES, P::NTB>(sV, P::CH);
    for (int i = 0; i < ST; ++i) {
      zero_chunk<BS, P::NTB>(reinterpret_cast<bf16*>(slot(i)), P::CH);
      zero_chunk<BS, P::NTB>(reinterpret_cast<bf16*>(slot(i) + P::ST_TILE), P::CH);
    }
  }
  fence_async_smem();
  __syncthreads();

  if (threadIdx.x >= NT) {   // the producer warpgroup: one warp copies, the rest leave
    setmaxnreg_dec<40>();
    if (threadIdx.x >= NT + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(bar.res, 2 * P::CH * RES * 16);
      for (int c = 0; c < P::CH; ++c) {
        tma_chunk(sK + c * RES * 8, &map_k, bar.res, c, h, k0, b);
        tma_chunk(sV + c * RES * 8, &map_v, bar.res, c, h, k0, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(bar.empty + s, (j / ST + 1) & 1);
      bf16* cQ = reinterpret_cast<bf16*>(slot(j));
      bf16* cdO = reinterpret_cast<bf16*>(slot(j) + P::ST_TILE);
      if (lane == 0) {
        mbar_arrive_tx(bar.full + s, 2 * P::CH * BS * 16);
        for (int c = 0; c < P::CH; ++c) {
          tma_chunk(cQ + c * BS * 8, &map_q, bar.full + s, c, h, j * BS, b);
          tma_chunk(cdO + c * BS * 8, &map_do, bar.full + s, c, h, j * BS, b);
        }
      }
      float* st = reinterpret_cast<float*>(slot(j) + 2 * P::ST_TILE);
      for (int r = lane; r < BS; r += 32) {
        const int t = j * BS + r;
        st[r] = t < T_len ? lse[sbase + (size_t)t * H] * kLog2e : 0.f;   // base 2
        st[BS + r] = t < T_len ? delta[sbase + (size_t)t * H] : 0.f;
      }
      mbar_arrive(bar.full + s);   // each lane, after its statistics; lane 0 also for the bytes
    }
    return;
  }

  setmaxnreg_inc<232>();   // the consumers take what the producer gave up
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  float acc[2][P::ND];   // dV, dK; set by the first tile's wgmma
  mbar_wait(bar.res, 0);
  uint32_t ka[P::AREG ? P::KS : 1][4], va[P::AREG ? P::KS : 1][4];   // K, V rows as A
  if constexpr (P::AREG) {
    load_a<RES>(ka, sK, 64 * wg + 16 * wi, g, t);
    load_a<RES>(va, sV, 64 * wg + 16 * wi, g, t);
  }
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(bar.full + i % ST, (i / ST) & 1);
    const unsigned char* s = slot(i);
    const bf16* cQ = reinterpret_cast<const bf16*>(s);
    const bf16* cdO = reinterpret_cast<const bf16*>(s + P::ST_TILE);
    const float* cL = reinterpret_cast<const float*>(s + 2 * P::ST_TILE);
    const float* cD = cL + BS;
    float x[NS], y[NS];   // S^T, dP^T: this warpgroup's 64 KV rows x the tile's BS Q rows
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KS; ++ks) {
      if constexpr (P::AREG) {
        wgmma_rs<0>(x, ka[ks], desc_k<BS>(cQ, 0, ks), ks > 0);
      } else {
        wgmma_ss(x, desc_k<RES>(launder(sK), 64 * wg, ks), desc_k<BS>(cQ, 0, ks), ks > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < P::KS; ++ks) {
      if constexpr (P::AREG) {
        wgmma_rs<0>(y, va[ks], desc_k<BS>(cdO, 0, ks), ks > 0);
      } else {
        wgmma_ss(y, desc_k<RES>(launder(sV), 64 * wg, ks), desc_k<BS>(cdO, 0, ks), ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();   // S^T is here, and the products of tile i - 1 are done
    reg_fence(x);
    if (i > 0 && lane == 0) mbar_arrive(bar.empty + (i - 1) % ST);
    // P^T in x: element e of 8-column block n is column (Q row) 8 n + 2 t + (e & 1).
    // No mask: a Q row past T arrives as zeros with lse = delta = 0, so its
    // P = 1 meets a zero dO row and its dS = 0 a zero Q row.
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[4 * n + e] = ex2(x[4 * n + e] * sl2 - cL[8 * n + 2 * t + (e & 1)]);
    uint32_t a[BS / 16][4];
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) a_frag(a[j], x, j);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BS / 16; ++j)
      wgmma_rs<1>(acc[0], a[j], desc_mn<BS>(cdO, 0, j), i + j > 0);
    wgmma_commit();
    wgmma_wait<1>();   // dP^T is here; dV += P^T dO runs on
    reg_fence(y);
    // dS^T
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        y[4 * n + e] = x[4 * n + e] * (y[4 * n + e] - cD[c]) * scale;
      }
    uint32_t a2[BS / 16][4];
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) a_frag(a2[j], y, j);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BS / 16; ++j)
      wgmma_rs<1>(acc[1], a2[j], desc_mn<BS>(cQ, 0, j), i + j > 0);
    wgmma_commit();   // dV and dK run on into the next tile's scores
  }
  wgmma_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  const size_t base = sbase * D;
  const int r0 = k0 + 64 * wg + 16 * wi;
  store_frag(dv + base, acc[0], r0, 0, T_len, H * D, g, t);
  store_frag(dk + base, acc[1], r0, 0, T_len, H * D, g, t);
}

// ---------------------------------------------------------------------------
// K3 in bf16, small plan: dQ.  Grid (ceil(T/RES), B*H); Q and dO resident
// (TMA), each thread's two rows of lse and delta in registers, K and V
// streamed by the producer warp.  Warpgroup w: Q rows [64 w, 64 w + 64).
//   S = Q K^T; dP = dO V^T; dS = exp(S scale - lse) (dP - delta) scale;
//   dQ += dS K.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(QPlan<D>::NTB, 1)
flash_bwd_q_kernel_tma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int T_len, int H, float scale) {
  using P = QPlan<D>;
  constexpr int RES = P::RES, BS = P::BS, NT = P::NT, NS = P::NS, ST = P::STAGES;
  extern __shared__ __align__(128) unsigned char smem_tma[];   // TMA: 128-byte aligned
  bf16* sQ = reinterpret_cast<bf16*>(smem_tma);
  bf16* sdO = sQ + RES * P::CP * 8;
  unsigned char* ring = smem_tma + 2 * P::RES_TILE;   // [STAGES][K, V]
  const Ring bar = ring_init<ST>(ring + ST * P::STAGE, 1, NT / 32);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * RES;
  const size_t sbase = (size_t)b * T_len * H + h;
  const int n_tiles = (T_len + BS - 1) / BS;
  auto slot = [&](int i) { return ring + (i % ST) * P::STAGE; };
  if constexpr (P::CP != P::CH) {
    zero_chunk<RES, P::NTB>(sQ, P::CH);
    zero_chunk<RES, P::NTB>(sdO, P::CH);
    for (int i = 0; i < ST; ++i) {
      zero_chunk<BS, P::NTB>(reinterpret_cast<bf16*>(slot(i)), P::CH);
      zero_chunk<BS, P::NTB>(reinterpret_cast<bf16*>(slot(i) + P::ST_TILE), P::CH);
    }
  }
  fence_async_smem();
  __syncthreads();

  if (threadIdx.x >= NT) {   // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x != NT) return;
    mbar_arrive_tx(bar.res, 2 * P::CH * RES * 16);
    for (int c = 0; c < P::CH; ++c) {
      tma_chunk(sQ + c * RES * 8, &map_q, bar.res, c, h, q0, b);
      tma_chunk(sdO + c * RES * 8, &map_do, bar.res, c, h, q0, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(bar.empty + s, (j / ST + 1) & 1);
      bf16* cK = reinterpret_cast<bf16*>(slot(j));
      bf16* cV = reinterpret_cast<bf16*>(slot(j) + P::ST_TILE);
      mbar_arrive_tx(bar.full + s, 2 * P::CH * BS * 16);
      for (int c = 0; c < P::CH; ++c) {
        tma_chunk(cK + c * BS * 8, &map_k, bar.full + s, c, h, j * BS, b);
        tma_chunk(cV + c * BS * 8, &map_v, bar.full + s, c, h, j * BS, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();   // the consumers take what the producer gave up
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  // this thread's Q rows: 16 wi + g and 16 wi + g + 8 of its warpgroup's 64
  const int r_own = q0 + 64 * wg + 16 * wi + g;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = r_own + 8 * r < T_len;
    l2[r] = ok ? lse[sbase + (size_t)(r_own + 8 * r) * H] * kLog2e : 0.f;
    dl[r] = ok ? delta[sbase + (size_t)(r_own + 8 * r) * H] : 0.f;
  }
  float dq_acc[P::ND];   // set by the first tile's wgmma
  mbar_wait(bar.res, 0);
  uint32_t qa[P::KS][4], oa[P::KS][4];   // Q, dO rows as A
  load_a<RES>(qa, sQ, 64 * wg + 16 * wi, g, t);
  load_a<RES>(oa, sdO, 64 * wg + 16 * wi, g, t);
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(bar.full + i % ST, (i / ST) & 1);
    const bf16* cK = reinterpret_cast<const bf16*>(slot(i));
    const bf16* cV = reinterpret_cast<const bf16*>(slot(i) + P::ST_TILE);
    const int k0 = i * BS;
    float x[NS], y[NS];   // S, dP: this warpgroup's 64 Q rows x the tile's BS KV rows
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KS; ++ks) wgmma_rs<0>(x, qa[ks], desc_k<BS>(cK, 0, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < P::KS; ++ks) wgmma_rs<0>(y, oa[ks], desc_k<BS>(cV, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S is here, and dQ of tile i - 1 is done
    reg_fence(x);
    if (i > 0 && lane == 0) mbar_arrive(bar.empty + (i - 1) % ST);
    // P in x: element e of 8-column block n is row r_own + 8 (e >> 1), column
    // (KV row) 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        x[4 * n + e] = k0 + c < T_len ? ex2(x[4 * n + e] * sl2 - l2[e >> 1]) : 0.f;
      }
    wgmma_wait<0>();
    reg_fence(y);
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[4 * n + e] = x[4 * n + e] * (y[4 * n + e] - dl[e >> 1]) * scale;
    uint32_t a[BS / 16][4];
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) a_frag(a[j], y, j);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) wgmma_rs<1>(dq_acc, a[j], desc_mn<BS>(cK, 0, j), i + j > 0);
    wgmma_commit();   // dQ runs on into the next tile's scores
  }
  wgmma_wait<0>();
  reg_fence(dq_acc);
  store_frag(dq + sbase * D, dq_acc, q0 + 64 * wg + 16 * wi, 0, T_len, H * D, g, t);
}

// --- the wide plan (D = 512): cp.async into a two-stage ring ---------------

// The four warpgroups' parts of a [64 x BS] score tile pair (x, y) summed in
// a fixed order, through `part` (each thread's fragment of each part).
template <int NWG, int NS>
__device__ __forceinline__ void sum_parts(float* part, float (&x)[NS], float (&y)[NS], int wg,
                                          int tw) {
  float4* mine = reinterpret_cast<float4*>(part) + (2 * wg * 128 + tw) * (NS / 4);
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mine[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    mine[128 * NS / 4 + j] = make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < NS; ++e) x[e] = y[e] = 0.f;
#pragma unroll 1
  for (int w = 0; w < NWG; ++w) {
    const float4* theirs = reinterpret_cast<const float4*>(part) + (2 * w * 128 + tw) * (NS / 4);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float4 u = theirs[j], z = theirs[128 * NS / 4 + j];
      x[4 * j] += u.x, x[4 * j + 1] += u.y, x[4 * j + 2] += u.z, x[4 * j + 3] += u.w;
      y[4 * j] += z.x, y[4 * j + 1] += z.y, y[4 * j + 2] += z.z, y[4 * j + 3] += z.w;
    }
  }
}

// ---------------------------------------------------------------------------
// K3 in bf16, wide plan (D = 512): dQ.  Grid (ceil(T/64), B*H); warpgroup w
// holds D columns [128 w, 128 w + 128) of dQ and its part of the scores.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(QPlan<D>::NT, 1)
flash_bwd_q_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int T_len, int H, float scale) {
  using P = QPlan<D>;
  constexpr int RES = P::RES, BS = P::BS, NT = P::NT, NS = P::NS;
  static_assert(P::WIDE, "the wide plan");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + RES * P::CP * 8;
  unsigned char* ring = smem_raw + 2 * P::RES_TILE;   // [STAGES][K, V]
  float* sLse = reinterpret_cast<float*>(ring + P::STAGES * P::STAGE);
  float* sDelta = sLse + RES;
  float* part = sDelta + RES;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * RES, rs = H * D;
  const size_t base = ((size_t)b * T_len * H + h) * D, sbase = (size_t)b * T_len * H + h;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  const int n_tiles = (T_len + BS - 1) / BS;

  // KV tile i into slot i % STAGES; one commit group each (see K2)
  auto slot = [&](int i) { return ring + (i % P::STAGES) * P::STAGE; };
  auto stage = [&](int i) {
    if (i < n_tiles) {
      unsigned char* s = slot(i);
      copy_tile<D, BS, NT>(reinterpret_cast<bf16*>(s), k + base, i * BS, T_len, rs);
      copy_tile<D, BS, NT>(reinterpret_cast<bf16*>(s + P::ST_TILE), v + base, i * BS, T_len, rs);
    }
    cp_async_commit();
  };
  copy_tile<D, RES, NT>(sQ, q + base, q0, T_len, rs);
  copy_tile<D, RES, NT>(sdO, dout + base, q0, T_len, rs);
  copy_stats<RES, NT>(sLse, lse + sbase, q0, T_len, H);
  copy_stats<RES, NT>(sDelta, delta + sbase, q0, T_len, H);
  for (int i = 0; i < P::STAGES - 1; ++i) stage(i);   // the first group carries Q, dO, lse, delta

  const int r_own = 16 * wi + g;   // this thread's Q rows: r_own and r_own + 8
  float dq_acc[P::ND];             // set by the first tile's wgmma
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<P::STAGES - 2>();
    fence_async_smem();
    __syncthreads();   // tile i is here; every thread is done with tile i - 1
    stage(i + P::STAGES - 1);
    const bf16* rQ = launder(sQ);
    const bf16* rdO = launder(sdO);
    const bf16* cK = reinterpret_cast<const bf16*>(slot(i));
    const bf16* cV = reinterpret_cast<const bf16*>(slot(i) + P::ST_TILE);
    const int k0 = i * BS;
    float x[NS], y[NS];   // this warpgroup's part of S and dP; set by wgmma
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KW; ++ks)
      wgmma_ss(x, desc_k<RES>(rQ, 0, P::KW * wg + ks), desc_k<BS>(cK, 0, P::KW * wg + ks),
               ks > 0);
#pragma unroll
    for (int ks = 0; ks < P::KW; ++ks)
      wgmma_ss(y, desc_k<RES>(rdO, 0, P::KW * wg + ks), desc_k<BS>(cV, 0, P::KW * wg + ks),
               ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(x);
    reg_fence(y);
    sum_parts<P::NWG>(part, x, y, wg, tw);
    // dS in y: element e of 8-column block n is row r_own + 8 (e >> 1),
    // column (KV row) 8 n + 2 t + (e & 1)
    const float l2[2] = {sLse[r_own] * kLog2e, sLse[r_own + 8] * kLog2e};
    const float dl[2] = {sDelta[r_own], sDelta[r_own + 8]};
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const float p = k0 + c < T_len ? ex2(x[4 * n + e] * sl2 - l2[e >> 1]) : 0.f;
        y[4 * n + e] = p * (y[4 * n + e] - dl[e >> 1]) * scale;
      }
    uint32_t a[4];
    a_frag(a, y, 0);
    wgmma_fence();
    wgmma_rs<1>(dq_acc, a, desc_mn<BS>(cK, P::DW / 8 * wg, 0), i > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_acc);
  }
  store_frag(dq + base, dq_acc, q0 + 16 * wi, P::DW * wg, T_len, rs, g, t);
}

// ---------------------------------------------------------------------------
// bf16 K1 on wgmma (sm_90a); see the note at the top for the plans.
// ---------------------------------------------------------------------------

// The bf16 plans of K1 for head dim D.
template <int D> struct FwdWgPlan {
  static constexpr bool WIDE = D > 128;
  static constexpr int NWG = WIDE ? 4 : 2;                // consumer warpgroups
  static constexpr int NT = 128 * NWG;                    // their threads
  static constexpr int NTB = NT + (WIDE ? 0 : 128);       // small: and a producer warpgroup
  static constexpr int RES = WIDE ? 64 : 64 * NWG;        // Q rows a block
  static constexpr int BS = WIDE ? 32 : 64;               // KV rows a streamed tile
  static constexpr int STAGES = WIDE ? 2 : 4;             // the ring's stages
  static constexpr int CH = D / 8, KS = (CH + 1) / 2;     // chunks of a row, k-steps over D
  static constexpr int CP = 2 * KS;                       // chunk columns kept (D = 40: one zero)
  static constexpr int DW = WIDE ? D / NWG : D;           // O columns a warpgroup
  static constexpr int KW = WIDE ? DW / 16 : KS;          // k-steps of a warpgroup's scores
  static constexpr int NS = BS / 2, ND = DW / 2;          // accumulator registers: S, O
  static constexpr int RES_TILE = RES * CP * 16, ST_TILE = BS * CP * 16;   // bytes
  static constexpr int STAGE = 2 * ST_TILE;               // a K and a V tile
  static constexpr int PART = WIDE ? NWG * 128 * NS * 4 : 0;       // wide: partial scores
  static constexpr int BARS = WIDE ? 0 : 8 * (2 * STAGES + 1);     // small: the ring's mbarriers
  static constexpr size_t smem = RES_TILE + STAGES * (size_t)STAGE + PART + BARS;
  static_assert(D % 8 == 0 && (WIDE ? DW % 16 == 0 : DW <= 256), "whole chunks and k-steps");
  static_assert(RES <= 256 && BS <= 256 && BS % 16 == 0, "TMA boxes; whole k-steps of P V");
  static_assert(smem <= 232448, "a block's shared memory");
};

// One step of the online softmax on a warpgroup's [64 x 2 NS] score tile x
// (rows 16 wi + g and + 8 of this thread; element e of 8-column block n is
// column 8 n + 2 t + (e & 1)), in base 2 (m is max S scale log2(e)): the
// columns from `valid` on are masked, m and this thread's part of l are
// updated, corr = 2^(m_prev - m) returned, and x becomes P.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&x)[NS], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int valid, float sl2, int t) {
  if (valid < 2 * NS) {
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * n + 2 * t + (e & 1) >= valid) x[4 * n + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[4 * n + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], group_max<4>(mx[r]) * sl2);   // finite: column 0 is valid
    corr[r] = ex2(m[r] - mn);                                    // 0 at the first tile
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < NS / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(x[4 * n + e], sl2, -m[e >> 1]));
      l[e >> 1] += p;
      x[4 * n + e] = p;
    }
}

// o = O / l rounded once to bf16 and (writer) lse = m ln 2 + log l for a
// warpgroup's accumulator of rows r0 + g, + 8 and columns [c0, c0 + 2 ND).
template <int ND>
__device__ __forceinline__ void fwd_epilogue(bf16* o, float* lse, float (&acc)[ND],
                                             const float (&m)[2], const float (&l)[2], int r0,
                                             int c0, int T_len, int H, int rs, bool writer,
                                             int g, int t) {
  constexpr float kLn2 = 0.6931471805599453f;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = group_sum<4>(l[r]);
    const int row = r0 + g + 8 * r;
    if (writer && t == 0 && row < T_len) lse[(size_t)row * H] = m[r] * kLn2 + logf(lr);
    inv[r] = 1.f / lr;
  }
#pragma unroll
  for (int n = 0; n < ND / 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * n + e] *= inv[e >> 1];
  store_frag(o, acc, r0, c0, T_len, rs, g, t);
}

// One KV tile i of the small plan, for one consumer warpgroup, entered with
// P_i in pa (bf16 A fragments), its rescale factor in corr and no product
// in flight: (NEXT) S_{i+1} = Q K_{i+1}^T is issued into x, O is rescaled
// and O += P_i V_i issued; S_{i+1}'s softmax runs while that product does;
// then slot i goes back and P_{i+1} goes to pa.  Every product is waited
// for inside, so that ptxas matches each wait to its products: a P V left
// in flight across the loop made it serialize wgmma (C7514).
template <int D, bool NEXT>
__device__ __forceinline__ void
fwd_tma_tile(float (&x)[FwdWgPlan<D>::NS], uint32_t (&pa)[FwdWgPlan<D>::BS / 16][4],
             float (&acc)[FwdWgPlan<D>::ND], float (&m)[2], float (&l)[2], float (&corr)[2],
             const uint32_t (&qa)[FwdWgPlan<D>::KS][4], unsigned char* ring, const Ring& bar,
             int i, int T_len, float sl2, int lane, int t) {
  using P = FwdWgPlan<D>;
  constexpr int BS = P::BS, ST = P::STAGES;
  if constexpr (NEXT) {
    mbar_wait(bar.full + (i + 1) % ST, ((i + 1) / ST) & 1);
    const bf16* cK = reinterpret_cast<const bf16*>(ring + ((i + 1) % ST) * P::STAGE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KS; ++ks) wgmma_rs<0>(x, qa[ks], desc_k<BS>(cK, 0, ks), ks > 0);
    wgmma_commit();
  }
  if (i > 0) {
#pragma unroll
    for (int n = 0; n < P::ND / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * n + e] *= corr[e >> 1];
  }
  const bf16* cV = reinterpret_cast<const bf16*>(ring + (i % ST) * P::STAGE + P::ST_TILE);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BS / 16; ++j) wgmma_rs<1>(acc, pa[j], desc_mn<BS>(cV, 0, j), i + j > 0);
  wgmma_commit();
  if constexpr (NEXT) {
    wgmma_wait<1>();   // S of tile i + 1 is here; P V of tile i runs on
    reg_fence(x);
    online_softmax(x, m, l, corr, T_len - (i + 1) * BS, sl2, t);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if constexpr (NEXT) {
    if (lane == 0) mbar_arrive(bar.empty + i % ST);
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) a_frag(pa[j], x, j);
  }
}

// ---------------------------------------------------------------------------
// K1 in bf16, small plan (D <= 80): o, lse.  Grid (ceil(T/RES), B*H); Q
// resident (TMA, then A fragments in registers), K and V streamed by the
// producer warp.  Warpgroup w: Q rows [64 w, 64 w + 64).  Tile i's
// O = O corr + P V runs while tile i + 1's S = Q K^T is issued and its
// softmax computed.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(FwdWgPlan<D>::NTB, 1)
flash_fwd_kernel_tma(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int T_len, int H, float scale) {
  using P = FwdWgPlan<D>;
  constexpr int RES = P::RES, BS = P::BS, NT = P::NT, NS = P::NS, ST = P::STAGES;
  extern __shared__ __align__(128) unsigned char smem_tma[];   // TMA: 128-byte aligned
  bf16* sQ = reinterpret_cast<bf16*>(smem_tma);
  unsigned char* ring = smem_tma + P::RES_TILE;   // [STAGES][K, V]
  const Ring bar = ring_init<ST>(ring + ST * P::STAGE, 1, NT / 32);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * RES;
  const size_t sbase = (size_t)b * T_len * H + h;
  const int n_tiles = (T_len + BS - 1) / BS;
  auto slot = [&](int i) { return ring + (i % ST) * P::STAGE; };
  if constexpr (P::CP != P::CH) {   // the zero chunk that pads D to whole k-steps
    zero_chunk<RES, P::NTB>(sQ, P::CH);
    for (int i = 0; i < ST; ++i) {
      zero_chunk<BS, P::NTB>(reinterpret_cast<bf16*>(slot(i)), P::CH);
      zero_chunk<BS, P::NTB>(reinterpret_cast<bf16*>(slot(i) + P::ST_TILE), P::CH);
    }
  }
  fence_async_smem();
  __syncthreads();

  if (threadIdx.x >= NT) {   // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x != NT) return;
    mbar_arrive_tx(bar.res, P::CH * RES * 16);
    for (int c = 0; c < P::CH; ++c) tma_chunk(sQ + c * RES * 8, &map_q, bar.res, c, h, q0, b);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(bar.empty + s, (j / ST + 1) & 1);
      bf16* cK = reinterpret_cast<bf16*>(slot(j));
      bf16* cV = reinterpret_cast<bf16*>(slot(j) + P::ST_TILE);
      mbar_arrive_tx(bar.full + s, 2 * P::CH * BS * 16);
      for (int c = 0; c < P::CH; ++c) {
        tma_chunk(cK + c * BS * 8, &map_k, bar.full + s, c, h, j * BS, b);
        tma_chunk(cV + c * BS * 8, &map_v, bar.full + s, c, h, j * BS, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();   // the consumers take what the producer gave up
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  mbar_wait(bar.res, 0);
  uint32_t qa[P::KS][4];   // this warp's 16 Q rows as A
  load_a<RES>(qa, sQ, 64 * wg + 16 * wi, g, t);
  float x[NS], acc[P::ND];   // S (then P) of a tile; O, set by the first P V
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  mbar_wait(bar.full, 0);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < P::KS; ++ks)
    wgmma_rs<0>(x, qa[ks], desc_k<BS>(reinterpret_cast<const bf16*>(slot(0)), 0, ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(x);
  online_softmax(x, m, l, corr, T_len, sl2, t);
  uint32_t pa[BS / 16][4];   // P as A, rounded to bf16
#pragma unroll
  for (int j = 0; j < BS / 16; ++j) a_frag(pa[j], x, j);
  for (int i = 0; i + 1 < n_tiles; ++i)
    fwd_tma_tile<D, true>(x, pa, acc, m, l, corr, qa, ring, bar, i, T_len, sl2, lane, t);
  fwd_tma_tile<D, false>(x, pa, acc, m, l, corr, qa, ring, bar, n_tiles - 1, T_len, sl2, lane, t);
  fwd_epilogue(o + sbase * D, lse + sbase, acc, m, l, q0 + 64 * wg + 16 * wi, 0, T_len, H, H * D,
               true, g, t);
}

// The four warpgroups' parts of a [64 x 2 NS] score tile summed in a fixed
// order, through `part` (each thread's fragment of each part), so that every
// warpgroup holds the same sums.
template <int NWG, int NS>
__device__ __forceinline__ void sum_parts(float* part, float (&x)[NS], int wg, int tw) {
  float4* base = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
    base[(wg * (NS / 4) + j) * 128 + tw] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < NS; ++e) x[e] = 0.f;
#pragma unroll 1
  for (int w = 0; w < NWG; ++w)
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float4 u = base[(w * (NS / 4) + j) * 128 + tw];
      x[4 * j] += u.x, x[4 * j + 1] += u.y, x[4 * j + 2] += u.z, x[4 * j + 3] += u.w;
    }
}

// ---------------------------------------------------------------------------
// K1 in bf16, wide plan (D = 512): o, lse.  Grid (ceil(T/64), B*H); the
// four warpgroups share 64 Q rows (resident in shared memory), warpgroup w
// holds O's columns [128 w, 128 w + 128) and computes S over them; the parts
// are summed, every warpgroup runs the same softmax on the sums and adds its
// columns of P V.  K and V tiles of 32 rows arrive by cp.async in a
// two-stage ring.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(FwdWgPlan<D>::NT, 1)
flash_fwd_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int T_len, int H, float scale) {
  using P = FwdWgPlan<D>;
  constexpr int RES = P::RES, BS = P::BS, NT = P::NT, NS = P::NS;
  static_assert(P::WIDE && P::STAGES == 2, "the wide plan");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + P::RES_TILE;   // [STAGES][K, V]
  float* part = reinterpret_cast<float*>(ring + P::STAGES * P::STAGE);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * RES, rs = H * D;
  const size_t sbase = (size_t)b * T_len * H + h, base = sbase * D;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int wi = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  const int n_tiles = (T_len + BS - 1) / BS;

  // KV tile i into slot i & 1; one commit group each (see K2)
  auto slot = [&](int i) { return ring + (i & 1) * P::STAGE; };
  auto stage = [&](int i) {
    if (i < n_tiles) {
      unsigned char* s = slot(i);
      copy_tile<D, BS, NT>(reinterpret_cast<bf16*>(s), k + base, i * BS, T_len, rs);
      copy_tile<D, BS, NT>(reinterpret_cast<bf16*>(s + P::ST_TILE), v + base, i * BS, T_len, rs);
    }
    cp_async_commit();
  };
  copy_tile<D, RES, NT>(sQ, q + base, q0, T_len, rs);
  stage(0);   // the first group carries Q

  float acc[P::ND];   // set by the first tile's P V
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile i is here; every thread is done with tile i - 1
    stage(i + 1);
    const bf16* rQ = launder(sQ);
    const bf16* cK = reinterpret_cast<const bf16*>(slot(i));
    const bf16* cV = reinterpret_cast<const bf16*>(slot(i) + P::ST_TILE);
    float x[NS];   // this warpgroup's part of S; set by wgmma
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::KW; ++ks)
      wgmma_ss(x, desc_k<RES>(rQ, 0, P::KW * wg + ks), desc_k<BS>(cK, 0, P::KW * wg + ks),
               ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(x);
    sum_parts<P::NWG>(part, x, wg, tw);
    float corr[2];
    online_softmax(x, m, l, corr, T_len - i * BS, sl2, t);
    if (i > 0) {
#pragma unroll
      for (int n = 0; n < P::ND / 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * n + e] *= corr[e >> 1];
    }
    uint32_t pa[BS / 16][4];
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) a_frag(pa[j], x, j);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BS / 16; ++j)
      wgmma_rs<1>(acc, pa[j], desc_mn<BS>(cV, P::DW / 8 * wg, j), i + j > 0);
    wgmma_commit();
    wgmma_wait<0>();   // the slot is refilled after the next barrier
    reg_fence(acc);
  }
  fwd_epilogue(o + base, lse + sbase, acc, m, l, q0 + 16 * wi, P::DW * wg, T_len, H, rs, wg == 0,
               g, t);
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map of a [B, T, H, D] bf16 tensor whose box is one chunk column: 8
// columns of `rows` rows of one (b, h); rows past T read as zeros.
bool chunk_map(CUtensorMap* map, const void* base, int B, int T_len, int H, int D, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T_len * H * D * 2};
  const cuuint32_t box[4] = {8, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int bwd_kv_wgmma_launch(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int T_len,
                        int H, float scale, cudaStream_t stream) {
  using P = KvPlan<D>;
  if constexpr (P::WIDE) {   // D = 512: the mma.sync plan, one TF32 pass (see the top)
    return bwd_kv_launch<bf16, D>(q, k, v, dout, lse, delta, dk, dv, B, T_len, H, scale, stream);
  } else {
    if (misaligned({q, k, v, dout, dk, dv})) return (int)cudaErrorMisalignedAddress;
    const dim3 grid((T_len + P::RES - 1) / P::RES, B * H);
    CUtensorMap mq, mk, mv, mdo;
    if (!chunk_map(&mq, q, B, T_len, H, D, P::BS) || !chunk_map(&mk, k, B, T_len, H, D, P::RES) ||
        !chunk_map(&mv, v, B, T_len, H, D, P::RES) || !chunk_map(&mdo, dout, B, T_len, H, D, P::BS))
      return (int)cudaErrorInvalidValue;
    auto fn = flash_bwd_kv_kernel_tma<D>;
    cudaError_t err = allow_smem(fn, P::smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<grid, P::NTB, P::smem, stream>>>(mq, mk, mv, mdo, (const float*)lse,
                                               (const float*)delta, (bf16*)dk, (bf16*)dv, T_len,
                                               H, scale);
    return (int)cudaGetLastError();
  }
}

template <int D>
int bwd_q_wgmma_launch(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int B, int T_len, int H,
                       float scale, cudaStream_t stream) {
  using P = QPlan<D>;
  if (misaligned({q, k, v, dout, dq})) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((T_len + P::RES - 1) / P::RES, B * H);
  if constexpr (P::WIDE) {
    auto fn = flash_bwd_q_kernel_wide<D>;
    cudaError_t err = allow_smem(fn, P::smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<grid, P::NT, P::smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                          (const bf16*)dout, (const float*)lse,
                                          (const float*)delta, (bf16*)dq, T_len, H, scale);
  } else {
    CUtensorMap mq, mk, mv, mdo;
    if (!chunk_map(&mq, q, B, T_len, H, D, P::RES) || !chunk_map(&mk, k, B, T_len, H, D, P::BS) ||
        !chunk_map(&mv, v, B, T_len, H, D, P::BS) || !chunk_map(&mdo, dout, B, T_len, H, D, P::RES))
      return (int)cudaErrorInvalidValue;
    auto fn = flash_bwd_q_kernel_tma<D>;
    cudaError_t err = allow_smem(fn, P::smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<grid, P::NTB, P::smem, stream>>>(mq, mk, mv, mdo, (const float*)lse,
                                               (const float*)delta, (bf16*)dq, T_len, H, scale);
  }
  return (int)cudaGetLastError();
}

// The card's SM count, read once.
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

// Whether bf16 K1 at D = 512 takes the wide wgmma plan: where its 64-row Q
// tiles give at least one block an SM.  Under one wave the 32-row mma.sync
// plan, with twice the blocks, is faster: at [1, 4096, 1, 512] (64 blocks)
// 0.426 ms against 0.577-0.585, while at [8, 4096, 1, 512] (512 blocks) the
// wide plan takes 2.437-2.453 ms against 3.366 (NVIDIA H100 80GB HBM3,
// 700 W; scripts/probe_flash_cuda.py --bf16 against the earlier source).
bool
fwd_wide_plan(int B, int T_len, int H) {
  return (long long)B * H * ((T_len + 63) / 64) >= sm_count();
}

template <int D>
int fwd_wgmma_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int T_len, int H, float scale, cudaStream_t stream) {
  using P = FwdWgPlan<D>;
  if (misaligned({q, k, v, o})) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((T_len + P::RES - 1) / P::RES, B * H);
  if constexpr (P::WIDE) {
    static_assert(P::RES == 64, "fwd_wide_plan counts 64-row blocks");
    if (!fwd_wide_plan(B, T_len, H))
      return fwd_launch<bf16, D>(q, k, v, o, lse, B, T_len, H, scale, stream);
    auto fn = flash_fwd_kernel_wide<D>;
    cudaError_t err = allow_smem(fn, P::smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<grid, P::NT, P::smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                          (bf16*)o, (float*)lse, T_len, H, scale);
  } else {
    CUtensorMap mq, mk, mv;
    if (!chunk_map(&mq, q, B, T_len, H, D, P::RES) || !chunk_map(&mk, k, B, T_len, H, D, P::BS) ||
        !chunk_map(&mv, v, B, T_len, H, D, P::BS))
      return (int)cudaErrorInvalidValue;
    auto fn = flash_fwd_kernel_tma<D>;
    cudaError_t err = allow_smem(fn, P::smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<grid, P::NTB, P::smem, stream>>>(mq, mk, mv, (bf16*)o, (float*)lse, T_len, H, scale);
  }
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
    return is_bf16 ? fwd_wgmma_launch<DD>(q, k, v, o, lse, B, T_len, H, scale, s) \
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
    return is_bf16 ? bwd_kv_wgmma_launch<DD>(q, k, v, dout, lse, delta, dk, dv, B, T_len, \
                                             H, scale, s)                                 \
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
    return is_bf16 ? bwd_q_wgmma_launch<DD>(q, k, v, dout, lse, delta, dq, B, T_len, H,  \
                                            scale, s)                                   \
                   : bwd_q_launch<float, DD>(q, k, v, dout, lse, delta, dq, B, T_len, H, \
                                             scale, s);
  switch (D) { TID_FOR_EACH_HEAD_DIM(TID_CASE) }
#undef TID_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
