// Device code shared by the unscaled-softmax attention kernels
// (fused_attention_fwd.cu, fused_attention_bwd.cu) on NVIDIA Hopper
// (sm_90a): the tile loads, the shared layout, the tensor-core products,
// the mask and the online row statistics.
//
// They replace the TPU kernels of mr_mt3_tpu/ops/train_attention.py
// (_fwd_kernel, pallas_call at :185; _bwd_kernel, pallas_call at :204).
// What bounds them and each kernel's design: the notes at the top of the
// two .cu files.
//
// Tiles. A warp owns 16 rows of a product (one m16n8k16 row block); a
// block of NWARPS warps owns 16 x NWARPS rows and walks the other side
// in tiles of TILE rows (64 keys, or 64 query rows in the dk/dv kernel).
// Every operand is a (rows, D) slice of the model's (B, L, H, D) layout,
// read with a row stride of H x D elements.
//
// Loads: cp.async, 16 bytes a thread, into a ring of two stages (the next
// tile's copy is in flight while the tensor cores work on this one). A
// chunk past the slice's valid rows or past the head width D is not read:
// cp.async with a source size of 0 writes 16 zero bytes. So the head width
// pads to Dp (a multiple of 16, the product's depth) with zeros in shared
// memory: at D = 24 the slot of columns 24-31 is zero-filled and never
// read from the next head (columns 0-7 of head h + 1 in the same row of
// global memory). Rows past Lq, or past the last key a block can see, are
// zeros too.
//
// Shared layout: each row padded by 8 bf16 (16 bytes), a row stride of
// Dp + 8 elements, which is 4 mod 8 in 4-byte words: the 8 rows an
// ldmatrix phase reads land in 8 distinct 4-bank groups, without
// conflicts.
//
// Products: mma.sync m16n8k16 (bf16 in, f32 sums) with operands from
// ldmatrix. Two forms:
//   nt_product: acc (16 x 64) = a (16 x Dp) . b^T, a and b both (rows, d)
//     in shared memory (q k^T, dO v^T, k q^T, v dO^T);
//   nn_product: acc (16 x Dp) += p (16 x 64) . m, p bf16 in registers
//     (the A fragments packed straight from an nt_product's accumulator),
//     m (64 rows, d) in shared memory read transposed (ldmatrix.trans).
// The sums run over the depth in one fixed order, so the same inputs give
// the same bits, and a recomputed score equals the first one bit for bit.
// Not done yet: wgmma (Hopper's warpgroup products, with TMA copies and a
// producer warp), which these building blocks would give way to.
//
// Accumulator layout of one 16 x 8 block (acc[n], columns 8n .. 8n + 7):
// lane = 4 g + t holds acc[n][e] at row g + 8 (e >> 1), column
// 8 n + 2 t + (e & 1). A row's values live in the 4 lanes of a quad.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

typedef __nv_bfloat16 bf16;

constexpr int WARP_ROWS = 16;  // rows of one m16n8k16 row block
constexpr int TILE = 64;       // rows of a streamed K / V (or Q / dO) tile
constexpr int NB = TILE / 8;   // 8-column blocks of a score tile
constexpr int PAD = 8;         // bf16 of padding per shared row
constexpr int MAX_D = 128;     // head width limit (the wrappers check it)

__host__ __device__ constexpr int lds(int Dp) { return Dp + PAD; }

// bytes of `rows` shared rows of a head width padded to Dp
__host__ __device__ constexpr size_t tile_bytes(int rows, int Dp) {
  return (size_t)rows * lds(Dp) * sizeof(bf16);
}

__host__ __device__ constexpr int padded_d(int D) { return (D + 15) & ~15; }

// ---- copies ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from src, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, ROWS) of a (rows, D) slice with row stride `stride` (elements)
// into dst (row stride lds(Dp)); row j is read only when j < nvalid, and
// columns D .. Dp - 1 are zeros. All NT threads of the block call it.
template <int ROWS, int Dp, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int nvalid, int D) {
  constexpr int CH = Dp / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int j = i / CH, c = (i - j * CH) * 8;
    const bool ok = j < nvalid && c < D;
    cp_async16(dst + j * lds(Dp) + c, ok ? src + (size_t)j * stride + c : src,
               ok);
  }
}

// ---- tensor-core products ---------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (16 x TILE) = a . b^T: a the warp's 16 rows, b TILE rows, both
// (rows, d) in shared memory with row stride lds(Dp), summed over d in
// 16-wide steps in order.
template <int Dp>
__device__ __forceinline__ void nt_product(float (&acc)[NB][4], const bf16* a,
                                           const bf16* b, int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* pa = a + (lane & 15) * lds(Dp) + (lane >> 4) * 8;
  const bf16* pb =
      b + (((lane >> 4) << 3) + (lane & 7)) * lds(Dp) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < Dp; k0 += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, pa + k0);
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t fb[4];   // b0, b1 of block n, then of block n + 1
      ldsm_x4(fb, pb + n * 8 * lds(Dp) + k0);
      mma16816(acc[n], fa, fb[0], fb[1]);
      mma16816(acc[n + 1], fa, fb[2], fb[3]);
    }
  }
}

// The A fragments (16 x TILE, bf16) of an accumulator's values, rounded
// to nearest even: k-step kk covers columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void to_fragments(uint32_t (&fa)[NB / 2][4],
                                             const float (&v)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    fa[kk][0] = pack_bf16(v[2 * kk][0], v[2 * kk][1]);
    fa[kk][1] = pack_bf16(v[2 * kk][2], v[2 * kk][3]);
    fa[kk][2] = pack_bf16(v[2 * kk + 1][0], v[2 * kk + 1][1]);
    fa[kk][3] = pack_bf16(v[2 * kk + 1][2], v[2 * kk + 1][3]);
  }
}

// acc (16 x Dp) += p (16 x TILE, A fragments) . m, m TILE rows of (row, d)
// in shared memory (row stride lds(Dp)), summed over the TILE rows in
// 16-row steps in order.
template <int Dp>
__device__ __forceinline__ void nn_product(float (&acc)[Dp / 8][4],
                                           const uint32_t (&p)[NB / 2][4],
                                           const bf16* m, int lane) {
  const bf16* pm =
      m + ((((lane >> 3) & 1) << 3) + (lane & 7)) * lds(Dp) + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
    for (int n = 0; n < Dp / 8; n += 2) {
      uint32_t fb[4];   // b0, b1 of column block n, then of n + 1
      ldsm_x4_t(fb, pm + kk * 16 * lds(Dp) + n * 8);
      mma16816(acc[n], p[kk], fb[0], fb[1]);
      mma16816(acc[n + 1], p[kk], fb[2], fb[3]);
    }
  }
}

// ---- mask and row statistics ---------------------------------------------

// Whether key `col` is visible to query row `row`: col < kv_valid and,
// with `causal`, col <= row. A masked score is -1e30 in the function, so
// its exp(s - max) is exactly 0: the kernels give it p = 0 directly.
__device__ __forceinline__ bool visible(int row, int col, int kv_valid,
                                        bool causal) {
  return col < kv_valid && !(causal && col > row);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(s - m) as exp2((s - m) log2(e)): a product and the ex2 unit in
// place of expf's range reduction. s - m is exact or nearly so for the
// scores that carry weight (s near m), so e moves by a few f32 ulps, far
// below p's bf16 step (ATTN_BOUNDS and ATTN_BWD_BOUNDS hold unchanged on
// it). Folding m log2(e) into one FMA instead rounds m log2(e) once per
// tile of sweep 1 and once more for sweep 2: those errors (~1e-6 of e at
// |m| ~ 30) do not cancel in p, and broke the forward's bounds.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp_shifted(float s, float m) {
  return exp2f((s - m) * LOG2E);
}

// Whether every key of a tile (col0 .. col0 + TILE - 1) is visible to
// every row from row0 on: then the per-score mask tests are skipped.
__device__ __forceinline__ bool tile_visible(int row0, int col0, int kv_valid,
                                             bool causal) {
  return col0 + TILE <= kv_valid && !(causal && col0 + TILE - 1 > row0);
}

// The online row statistics of one score tile (rows `row[0]`, `row[1]`
// of this lane, keys col0 + 8 n + 2 t + (e & 1); MASK false when
// tile_visible holds for the warp): the running max m and sum l = sum
// exp(s - m) in f32, rescaled by exp(m_old - m_new) when the max grows;
// with `dp`, also u = sum exp(s - m) dp, rescaled alike, so that u / l =
// sum p dp (the backward's delta) after the last tile.
template <bool WITH_DP, bool MASK>
__device__ __forceinline__ void online_stats(
    const float (&s)[NB][4], const float (&dp)[NB][4], const int (&row)[2],
    int col0, int kv_valid, bool causal, float (&m)[2], float (&l)[2],
    float (&u)[2]) {
  const int t = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!MASK || visible(row[e >> 1], col0 + 8 * n + 2 * t + (e & 1),
                           kv_valid, causal))
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  float mnew[2], sum[2] = {0.f, 0.f}, sumd[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mnew[r] = fmaxf(m[r], quad_max(mx[r]));
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!MASK || visible(row[e >> 1], col0 + 8 * n + 2 * t + (e & 1),
                           kv_valid, causal)) {
        const float x = exp_shifted(s[n][e], mnew[e >> 1]);
        sum[e >> 1] += x;
        if (WITH_DP) sumd[e >> 1] += x * dp[n][e];
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // no visible column yet: l and u stay 0 (exp(-inf - -inf) is NaN)
    const float scale =
        m[r] == -INFINITY ? 0.f : exp_shifted(m[r], mnew[r]);
    l[r] = l[r] * scale + quad_sum(sum[r]);
    if (WITH_DP) u[r] = u[r] * scale + quad_sum(sumd[r]);
    m[r] = mnew[r];
  }
}

// p = exp(s - m) / l over a score tile in place (rows `row[0]`,
// `row[1]`, keys col0 + 8 n + 2 t + (e & 1)), 0 where masked: the
// function's normalized probability in f32, before any rounding. Takes
// m and 1 / l per row (one IEEE division a row; a product by the
// reciprocal differs from the quotient by at most an f32 ulp or so).
template <bool MASK>
__device__ __forceinline__ void probabilities(float (&s)[NB][4],
                                              const float (&m)[2],
                                              const float (&rl)[2],
                                              const int (&row)[2], int col0,
                                              int kv_valid, bool causal) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp_shifted(s[n][e], m[e >> 1]) * rl[e >> 1];
      s[n][e] = !MASK || visible(row[e >> 1], col0 + 8 * n + 2 * t + (e & 1),
                                 kv_valid, causal)
                    ? p
                    : 0.f;
    }
}

// Store a (16 x Dp) f32 accumulator's rows < nrows and columns < D as
// bf16 pairs to dst (row stride `stride` elements; this lane's rows
// row0 + g and row0 + g + 8).
template <int Dp>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float (&acc)[Dp / 8][4],
                                           int row0, int nrows, int D,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < nrows)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * stride + d) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

}  // namespace fa
