// Unscaled-softmax attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mr_mt3_tpu/ops/train_attention.py::_bwd_kernel
// (pallas_call at :204 in _call_bwd_local, the VJP _fused_bwd :304). Per
// (batch row, head) it computes, as the TPU kernel does:
//   s  = q . k^T with f32 sums, NOT scaled (T5); columns >= kv_valid, and
//        with `causal` columns > row, masked;
//   p  = softmax(s) in f32, normalized;   pb = bf16(p);
//   dv = pb^T . dO   (f32 sums);
//   dp = dO . v^T    (f32);
//   ds = p * (dp - rowsum(dp * p))       (f32; delta from f32 p and f32 dp,
//        NOT FlashAttention-2's rowsum(dO * O): O was computed from the
//        bf16-rounded p, so the two differ);
//   dq = bf16(ds) . k,  dk = bf16(ds)^T . q  (f32 sums);
// dq, dk and dv rounded to bf16. Built without --use_fast_math: expf and the
// divisions are the IEEE ones. A masked column has p = 0 and so ds = 0
// exactly; K rows past kv_valid get exact-zero dk and dv (the wrapper's
// autograd trims them with the padding).
//
// Layout: q, dO, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D), contiguous,
// bf16, the model's layout. Lk is the padded length (a multiple of 128,
// ops/train_attention.py::_pad_kv).
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16): at the memory
// encoder's training shape, B = 12, H = 6, L = 1024, D = 64, the five
// products (q k^T, dO v^T, pb^T dO, ds k, ds^T q) are 5 x 2 B H L^2 D = 48
// GFLOP, about 49 us on the tensor cores, while its seven tensors of 9.4 MB
// move in about 20 us: it is bound by operations. chip_smoke.py computes the
// bound of each case from the columns each row sees.
//
// Design (right, deterministic and simple first): two kernels, no atomics.
//  (a) fab_dq_kernel, one block of 256 threads per (16 query rows, head,
//      batch row), as the forward: the block keeps its rows' f32 score rows
//      AND f32 dp rows in shared memory (2 x 16 x Lk floats: 128 KB at Lk
//      1024), takes the softmax (max, sum, p) and delta per row, writes the
//      row max, row sum and delta to a (3, B, H, Lq) f32 scratch, rounds ds
//      to bf16 over the first half of its own dp row, and sums dq = ds k
//      over K tiles of 128 keys.
//  (b) fab_dkdv_kernel, one block per (64 keys, head, batch row), keeps its
//      K and V rows in shared memory and walks the 16-row query tiles that
//      can see them (with `causal`, from the tile of its first key on). For
//      each it recomputes the score and dp blocks with the same WMMA calls
//      in the same order as (a), so p = exp(s - max) / sum and ds come out
//      bit-identical to (a)'s from the stored statistics, and adds
//      pb^T dO and ds^T q into register accumulators (each warp owns a
//      fixed set of 16 x 16 output tiles). The sum over query rows thus
//      runs in one fixed order: the same inputs give the same bits.
// The products run on the tensor cores (WMMA 16x16x16, bf16 in, f32 sums);
// the head width is zero-padded to a multiple of 16 in shared memory, which
// adds exact zeros. Not done yet: reuse of K/V across (a)'s query tiles,
// copies overlapped with the products, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace wmma = nvcuda::wmma;

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define ROWS 16        // query rows per tile (one WMMA row block)
#define KT 128         // (a): keys per K / V tile (16 keys per warp)
#define KB 64          // (b): keys per block
#define MAX_D 128      // head width limit (the wrapper checks it)
#define PART_FLOATS (ROWS * 128)  // (a): the dq shares, splits x 16 x Dp

static_assert(KT == 16 * NWARPS, "one 16-key block per warp in (a)");
static_assert(2 * (KB / 16) == NWARPS, "one score or dp block per warp in (b)");

typedef __nv_bfloat16 bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;   // (3, B, H, Lq): row max, row sum, delta
  int B, Lq, Lk, H, D, kv_valid, causal;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether column c is masked for query row `row` (absolute).
__device__ __forceinline__ bool masked(const Args& a, int row, int c) {
  return c >= a.kv_valid || (a.causal && c > row);
}

// rows [0, n) of a (rows, D) slice with row stride `stride` (elements) into
// dst[j * Dp + d] as bf16, zero past n and past D; 8 values per load.
__device__ void load_rows_bf16(const bf16* src, size_t stride, int n,
                               int rows, int D, int Dp, bf16* dst) {
  const int per_row = Dp / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
    const int j = i / per_row, d = (i - j * per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (j < n && d < D)
      v = *reinterpret_cast<const uint4*>(src + (size_t)j * stride + d);
    *reinterpret_cast<uint4*>(dst + (size_t)j * Dp + d) = v;
  }
}

// One 16 x 16 block of a . b^T: a 16 rows x Dp (row-major, ld Dp), b 16 rows
// x Dp (ld Dp); f32 sums over the head width in 16-wide steps, stored to out
// (ld ldo). (a) and (b) both call this, so their blocks are equal bit for
// bit.
__device__ __forceinline__ void nt_block(const bf16* a, const bf16* b, int Dp,
                                         float* out, int ldo) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int d0 = 0; d0 < Dp; d0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a + d0, Dp);
    wmma::load_matrix_sync(fb, b + d0, Dp);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(out, acc, ldo, wmma::mem_row_major);
}

// ---- (a): statistics, delta and dq per 16-row query tile -----------------

__global__ void __launch_bounds__(NTHREADS)
    fab_dq_kernel(Args a, int Dp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Lk = a.Lk, D = a.D;
  float* s = reinterpret_cast<float*>(smem_raw);   // ROWS x Lk: s, then p
  float* dp = s + (size_t)ROWS * Lk;               // ROWS x Lk: dp
  bf16* ds = reinterpret_cast<bf16*>(dp);          // bf16 ds, row stride 2 Lk
  bf16* qs = reinterpret_cast<bf16*>(dp + (size_t)ROWS * Lk);
  bf16* dos = qs + ROWS * Dp;                      // ROWS x Dp
  bf16* kv = dos + ROWS * Dp;                      // KT x Dp
  float* part = reinterpret_cast<float*>(kv + KT * Dp);  // PART_FLOATS
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(ROWS, a.Lq - row0);
  const size_t hd = (size_t)a.H * D;
  const size_t qoff = ((size_t)b * a.Lq + row0) * hd + (size_t)h * D;
  const size_t kvoff = (size_t)b * Lk * hd + (size_t)h * D;
  const bf16* K = static_cast<const bf16*>(a.k) + kvoff;
  const bf16* V = static_cast<const bf16*>(a.v) + kvoff;
  int ncols = a.kv_valid;
  if (a.causal) ncols = min(ncols, row0 + nrows);
  const int ncols16 = (ncols + 15) & ~15;   // the 16-key blocks read

  load_rows_bf16(static_cast<const bf16*>(a.q) + qoff, hd, nrows, ROWS, D,
                 Dp, qs);
  load_rows_bf16(static_cast<const bf16*>(a.dout) + qoff, hd, nrows, ROWS,
                 D, Dp, dos);
  // s = q k^T, then dp = dO v^T, tile by tile
  for (int k0 = 0; k0 < ncols; k0 += KT) {
    for (int pass = 0; pass < 2; ++pass) {
      __syncthreads();
      load_rows_bf16((pass ? V : K) + (size_t)k0 * hd, hd,
                     min(KT, ncols - k0), KT, D, Dp, kv);
      __syncthreads();
      const int j0 = k0 + 16 * warp;
      if (j0 < ncols)
        nt_block(pass ? dos : qs, kv + 16 * warp * Dp, Dp,
                 (pass ? dp : s) + j0, Lk);
    }
  }
  __syncthreads();

  const size_t bhl = (size_t)a.B * a.H * a.Lq;
  const size_t srow = ((size_t)b * a.H + h) * a.Lq + row0;
  for (int r = warp; r < ROWS; r += NWARPS) {
    float* sr = s + (size_t)r * Lk;
    float* dpr = dp + (size_t)r * Lk;
    bf16* dsr = ds + (size_t)r * 2 * Lk;
    const int row = row0 + r;
    float delta = 0.f;
    if (r < nrows) {
      float m = -INFINITY;
      for (int c = lane; c < ncols; c += 32)
        if (!masked(a, row, c)) m = fmaxf(m, sr[c]);
      m = warp_max(m);
      float l = 0.f;
      for (int c = lane; c < ncols; c += 32) {
        const float e = masked(a, row, c) ? 0.f : expf(sr[c] - m);
        sr[c] = e;
        l += e;
      }
      l = warp_sum(l);
      for (int c = lane; c < ncols; c += 32) {
        const float p = sr[c] / l;
        sr[c] = p;
        delta += dpr[c] * p;
      }
      delta = warp_sum(delta);
      if (lane == 0) {
        a.stats[srow + r] = m;
        a.stats[bhl + srow + r] = l;
        a.stats[2 * bhl + srow + r] = delta;
      }
    }
    // bf16 ds over the first half of the dp row's own bytes: element c
    // lands in float c / 2, which this warp has read already (in this or
    // an earlier step: for c >= 32 it is below 32 * step)
    for (int c0 = 0; c0 < ncols16; c0 += 32) {
      const int c = c0 + lane;
      float v = 0.f;
      if (r < nrows && c < ncols && !masked(a, row, c))
        v = sr[c] * (dpr[c] - delta);
      __syncwarp();
      if (c < ncols16) dsr[c] = __float2bfloat16_rn(v);
      __syncwarp();
    }
  }

  // dq = ds k: warp -> (output column tile t, key-block share sp)
  const int ntiles = Dp / 16, nsplit = NWARPS / ntiles;
  const int t = warp % ntiles, sp = warp / ntiles;
  const bool busy = sp < nsplit;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int k0 = 0; k0 < ncols16; k0 += KT) {
    __syncthreads();
    load_rows_bf16(K + (size_t)k0 * hd, hd, min(KT, ncols - k0), KT, D, Dp,
                   kv);
    __syncthreads();
    if (!busy) continue;
    for (int kb = sp; kb < KT / 16 && k0 + 16 * kb < ncols16; kb += nsplit) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, ds + k0 + 16 * kb, 2 * Lk);
      wmma::load_matrix_sync(fb, kv + 16 * kb * Dp + 16 * t, Dp);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  if (busy)
    wmma::store_matrix_sync(part + (size_t)sp * ROWS * Dp + 16 * t, acc, Dp,
                            wmma::mem_row_major);
  __syncthreads();
  bf16* DQ = static_cast<bf16*>(a.dq) + qoff;
  for (int i = threadIdx.x; i < nrows * D; i += NTHREADS) {
    const int r = i / D, d = i - r * D;
    float v = 0.f;
    for (int j = 0; j < nsplit; ++j)
      v += part[((size_t)j * ROWS + r) * Dp + d];
    DQ[(size_t)r * hd + d] = __float2bfloat16_rn(v);
  }
}

// ---- (b): dk and dv per 64-key block --------------------------------------
//
// NF = Dp / 16 output tiles of dv and NF of dk per warp: the 2 x (KB / 16) x
// (Dp / 16) tiles of the block's dv and dk, split evenly over the 8 warps.

template <int NF>
__global__ void __launch_bounds__(NTHREADS, 2)
    fab_dkdv_kernel(Args a) {
  constexpr int Dp = 16 * NF;
  constexpr int NTILE = 2 * (KB / 16) * NF;   // dv tiles, then dk tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // KB x Dp
  bf16* vs = ks + KB * Dp;                        // KB x Dp
  bf16* qs = vs + KB * Dp;                        // ROWS x Dp
  bf16* dos = qs + ROWS * Dp;                     // ROWS x Dp
  float* s = reinterpret_cast<float*>(dos + ROWS * Dp);  // ROWS x KB
  float* dp = s + ROWS * KB;                      // ROWS x KB
  bf16* pb = reinterpret_cast<bf16*>(dp + ROWS * KB);    // ROWS x KB
  bf16* dsb = pb + ROWS * KB;                     // ROWS x KB
  float* st = reinterpret_cast<float*>(dsb + ROWS * KB); // 3 x ROWS
  float* outs = reinterpret_cast<float*>(smem_raw);  // KB x Dp, over ks/vs
  const int D = a.D, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * KB, h = blockIdx.y, b = blockIdx.z;
  const size_t hd = (size_t)a.H * D;
  const size_t kvoff = ((size_t)b * a.Lk + j0) * hd + (size_t)h * D;
  const size_t qbase = (size_t)b * a.Lq * hd + (size_t)h * D;
  const size_t bhl = (size_t)a.B * a.H * a.Lq;
  const size_t sbase = ((size_t)b * a.H + h) * a.Lq;
  const int nk = min(KB, a.kv_valid - j0);   // keys this block can see

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  if (nk > 0) {
    load_rows_bf16(static_cast<const bf16*>(a.k) + kvoff, hd, nk, KB, D, Dp,
                   ks);
    load_rows_bf16(static_cast<const bf16*>(a.v) + kvoff, hd, nk, KB, D, Dp,
                   vs);
    // with `causal`, rows before j0 see none of these keys
    const int rstart = a.causal ? (j0 / ROWS) * ROWS : 0;
    for (int r0 = rstart; r0 < a.Lq; r0 += ROWS) {
      const int nrows = min(ROWS, a.Lq - r0);
      __syncthreads();   // the last tile's reads are done
      load_rows_bf16(static_cast<const bf16*>(a.q) + qbase + (size_t)r0 * hd,
                     hd, nrows, ROWS, D, Dp, qs);
      load_rows_bf16(static_cast<const bf16*>(a.dout) + qbase +
                         (size_t)r0 * hd,
                     hd, nrows, ROWS, D, Dp, dos);
      if (threadIdx.x < 3 * ROWS) {
        const int which = threadIdx.x / ROWS, r = threadIdx.x % ROWS;
        st[threadIdx.x] =
            r < nrows ? a.stats[which * bhl + sbase + r0 + r] : 1.f;
      }
      __syncthreads();
      // warps 0-3: the score blocks q k^T; warps 4-7: the dp blocks dO v^T
      {
        const int jb = warp % (KB / 16);
        const bool isdp = warp >= KB / 16;
        nt_block(isdp ? dos : qs, (isdp ? vs : ks) + 16 * jb * Dp, Dp,
                 (isdp ? dp : s) + 16 * jb, KB);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < ROWS * KB; i += NTHREADS) {
        const int r = i / KB, c = j0 + (i - r * KB);
        float p = 0.f, d = 0.f;
        if (r < nrows && !masked(a, r0 + r, c)) {
          p = expf(s[i] - st[r]) / st[ROWS + r];
          d = p * (dp[i] - st[2 * ROWS + r]);
        }
        pb[i] = __float2bfloat16_rn(p);
        dsb[i] = __float2bfloat16_rn(d);
      }
      __syncthreads();
      // dv += pb^T dO, dk += ds^T q over this tile's 16 rows
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int tile = warp + f * NWARPS;
        const bool isdk = tile >= NTILE / 2;
        const int tt = isdk ? tile - NTILE / 2 : tile;
        const int kt = tt / NF, dt = tt % NF;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, (isdk ? dsb : pb) + 16 * kt, KB);
        wmma::load_matrix_sync(fb, (isdk ? qs : dos) + 16 * dt, Dp);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }

  // dv, then dk, through shared memory (over ks/vs) to bf16 rows
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int tile = warp + f * NWARPS;
      if ((tile >= NTILE / 2) == (which == 1)) {
        const int tt = which ? tile - NTILE / 2 : tile;
        const int kt = tt / NF, dt = tt % NF;
        wmma::store_matrix_sync(outs + 16 * kt * Dp + 16 * dt, acc[f], Dp,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    bf16* O = static_cast<bf16*>(which ? a.dk : a.dv) + kvoff;
    for (int i = threadIdx.x; i < KB * D; i += NTHREADS) {
      const int j = i / D, d = i - j * D;
      O[(size_t)j * hd + d] = __float2bfloat16_rn(outs[j * Dp + d]);
    }
  }
}

// ---- launch -------------------------------------------------------------

static size_t smem_dq(int Lk, int D) {
  const size_t Dp = (D + 15) & ~15;
  return 2 * 4 * (size_t)ROWS * Lk + 2 * 2 * (size_t)ROWS * Dp +
         2 * (size_t)KT * Dp + 4 * (size_t)PART_FLOATS;
}

static size_t smem_dkdv(int D) {
  const size_t Dp = (D + 15) & ~15;
  return 2 * 2 * (size_t)KB * Dp + 2 * 2 * (size_t)ROWS * Dp +
         2 * 4 * (size_t)ROWS * KB + 2 * 2 * (size_t)ROWS * KB +
         4 * 3 * (size_t)ROWS;
}

template <int NF>
static cudaError_t launch_dkdv(const Args& a, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fab_dkdv_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Lk / KB, a.H, a.B), block(NTHREADS);
  fab_dkdv_kernel<NF><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

extern "C" {

// The kernels' constants and shared-memory sizes, so the wrapper sizes and
// checks alike.
int fab_rows() { return ROWS; }
int fab_key_block() { return KB; }
int fab_max_d() { return MAX_D; }
long long fab_smem_dq(int Lk, int D) { return (long long)smem_dq(Lk, D); }
long long fab_smem_dkdv(int D) { return (long long)smem_dkdv(D); }

// Launch (a) then (b) on `stream`. Returns cudaGetLastError() after the
// launches (0 when both were accepted), or cudaErrorInvalidValue for
// arguments the kernels do not take. The wrapper has checked shapes, the
// bf16 type, contiguity and 16-byte alignment, and allocated dq, dk, dv and
// the (3, B, H, Lq) f32 stats scratch.
int fab_launch(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int B, int Lq,
               int Lk, int H, int D, int kv_valid, int causal, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Lk % KB || H < 1 || D < 8 ||
      D > MAX_D || D % 8 || kv_valid < 1 || kv_valid > Lk || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.stats = stats;
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.D = D;
  a.kv_valid = kv_valid; a.causal = causal ? 1 : 0;
  const size_t sa = smem_dq(Lk, D), sb = smem_dkdv(D);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (sa > (size_t)optin || sb > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaFuncSetAttribute(fab_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sa);
  if (err != cudaSuccess) return (int)err;
  const int Dp = (D + 15) & ~15;
  fab_dq_kernel<<<dim3((Lq + ROWS - 1) / ROWS, H, B), dim3(NTHREADS), sa,
                  st>>>(a, Dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (Dp / 16) {
    case 1: return (int)launch_dkdv<1>(a, sb, st);
    case 2: return (int)launch_dkdv<2>(a, sb, st);
    case 3: return (int)launch_dkdv<3>(a, sb, st);
    case 4: return (int)launch_dkdv<4>(a, sb, st);
    case 5: return (int)launch_dkdv<5>(a, sb, st);
    case 6: return (int)launch_dkdv<6>(a, sb, st);
    case 7: return (int)launch_dkdv<7>(a, sb, st);
    case 8: return (int)launch_dkdv<8>(a, sb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
