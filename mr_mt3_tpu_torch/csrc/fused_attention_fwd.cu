// Unscaled-softmax attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mr_mt3_tpu/ops/train_attention.py::_fwd_kernel
// (pallas_call at :185 in _call_fwd_local, behind fused_attention :166), the
// forward only. Per (batch row, head) it computes, as the TPU kernel does:
//   s = q . k^T from the inputs' values with f32 sums; NOT scaled (T5);
//   columns >= kv_valid, and with `causal` columns > row, set to -1e30;
//   m = max(s), e = exp(s - m), p = e / sum(e), all in f32;
//   p rounded to bf16 BEFORE the value sum;
//   o = p . v with f32 sums, rounded to bf16.
// bf16 only: 'auto' routes only bf16 models here (models/mt3.py), and the
// wrapper raises for other types on the card.
// The probabilities are normalized before they are rounded, as the TPU
// kernel and the einsum path do: a flash-style kernel that divides at the
// end rounds other values. Built without --use_fast_math, so expf and the
// division are the IEEE ones. A masked column's e is exp(-1e30 - m) = 0
// exactly, so the kernel gives it p = 0 without computing it, the
// zero-padded K/V rows past kv_valid never reach the max or the sums, and
// a block stops at the last column any of its rows can see (kv_valid, or
// with `causal` its last row).
//
// Layout: q and out (B, Lq, H, D), k and v (B, Lk, H, D), contiguous, in the
// model's layout: no transpose pass (that pass was a TPU block-shape rule,
// train_attention.py:136-149). Lk is the padded length (a multiple of 128,
// ops/train_attention.py::_pad_kv).
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16): the memory encoder
// call, B = 8, H = 6, L = 1024, D = 64, moves 4 x 6.3 MB (q, k, v, out) and
// does 4 B H L^2 D = 12.9 GFLOP, about 13 us on the tensor cores: it is
// bound by operations. chip_smoke.py computes the bound of each case.
//
// Design (right and simple first): one block of 256 threads (8 warps) per
// (16 query rows, head, batch row). The block keeps its rows' full f32
// score rows in shared memory (16 x Lk floats: 64 KB at Lk 1024), as the
// TPU kernel keeps the whole score matrix in VMEM. The products run on the
// tensor cores (WMMA 16x16x16, bf16 in, f32 sums). K passes through shared
// memory in tiles of 128 keys, one 16-key score block per warp; the head
// width is zero-padded to a multiple of 16 there, which adds exact zeros.
// Softmax: one warp per row, normalized, rounded to bf16 in place (the bf16
// row overwrites the first half of its own f32 row, behind the reads).
// Values: V tiles of 128 keys; each warp owns a 16-wide output column tile
// and a share of the key blocks, and the shares are summed in a fixed
// order. Shared memory at Lk 1024, D 64: 90 KB, two blocks per SM.
// Not done yet: K/V reuse across the query tiles of one head (each block
// reads its head's K and V from L2 again), copies overlapped with the
// products, and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace wmma = nvcuda::wmma;

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define ROWS 16        // query rows per block (one WMMA row block)
#define KT 128         // keys per K / V tile (16 keys per warp)
#define MAX_D 128      // head width limit (the wrapper checks it)
#define PART_FLOATS (ROWS * 128)  // the value shares: splits x 16 x Dp

static_assert(KT == 16 * NWARPS, "one 16-key score block per warp");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
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

// Whether column c of row r (block-relative) is masked.
__device__ __forceinline__ bool masked(const Args& a, int row0, int r,
                                       int c) {
  return c >= a.kv_valid || (a.causal && c > row0 + r);
}

// Softmax of one score row over columns < ncols: max and sum over the
// unmasked columns, p = e / sum (masked: 0). Leaves e in sr[c] (f32).
// Returns the sum; every lane of the warp gets it.
__device__ float softmax_row(const Args& a, float* sr, int row0, int r,
                             int ncols, int lane) {
  float m = -INFINITY;
  for (int c = lane; c < ncols; c += 32)
    if (!masked(a, row0, r, c)) m = fmaxf(m, sr[c]);
  m = warp_max(m);
  float l = 0.f;
  for (int c = lane; c < ncols; c += 32) {
    const float e = masked(a, row0, r, c) ? 0.f : expf(sr[c] - m);
    sr[c] = e;
    l += e;
  }
  return warp_sum(l);
}

// rows [0, n) of a (rows, D) slice with row stride `stride` (elements) into
// dst[j * Dp + d] as bf16, zero past n and past D; 8 values per load.
__device__ void load_rows_bf16(const __nv_bfloat16* src, size_t stride,
                               int n, int rows, int D, int Dp,
                               __nv_bfloat16* dst) {
  const int per_row = Dp / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += NTHREADS) {
    const int j = i / per_row, d = (i - j * per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (j < n && d < D)
      v = *reinterpret_cast<const uint4*>(src + (size_t)j * stride + d);
    *reinterpret_cast<uint4*>(dst + (size_t)j * Dp + d) = v;
  }
}

__global__ void __launch_bounds__(NTHREADS)
    faf_kernel(Args a, int Dp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Lk = a.Lk, D = a.D;
  float* s = reinterpret_cast<float*>(smem_raw);          // ROWS x Lk f32
  __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(s);  // row stride 2 Lk
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(s + ROWS * Lk);
  __nv_bfloat16* kv = qs + ROWS * Dp;                      // KT x Dp
  float* part = reinterpret_cast<float*>(kv + KT * Dp);    // PART_FLOATS
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(ROWS, a.Lq - row0);
  const size_t hd = (size_t)a.H * D;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) +
                           ((size_t)b * a.Lq + row0) * hd + (size_t)h * D;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(a.k) + (size_t)b * Lk * hd +
      (size_t)h * D;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(a.v) + (size_t)b * Lk * hd +
      (size_t)h * D;
  int ncols = a.kv_valid;
  if (a.causal) ncols = min(ncols, row0 + nrows);
  const int ncols16 = (ncols + 15) & ~15;   // the 16-key blocks read

  load_rows_bf16(Q, hd, nrows, ROWS, D, Dp, qs);
  for (int k0 = 0; k0 < ncols; k0 += KT) {
    __syncthreads();
    load_rows_bf16(K + (size_t)k0 * hd, hd, min(KT, ncols - k0), KT, D, Dp,
                   kv);
    __syncthreads();
    const int j0 = k0 + 16 * warp;
    if (j0 < ncols) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d0 = 0; d0 < Dp; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + d0, Dp);
        wmma::load_matrix_sync(fb, kv + 16 * warp * Dp + d0, Dp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(s + j0, acc, Lk, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int r = warp; r < ROWS; r += NWARPS) {
    float* sr = s + (size_t)r * Lk;
    __nv_bfloat16* pr = p + (size_t)r * 2 * Lk;
    const float l = r < nrows ? softmax_row(a, sr, row0, r, ncols, lane)
                              : 1.f;
    // bf16 p over the first half of the row's own bytes: element c lands
    // in float c / 2, which this warp has read already (in this or an
    // earlier step: for c >= 32 it is below 32 * step)
    for (int c0 = 0; c0 < ncols16; c0 += 32) {
      const int c = c0 + lane;
      float v = 0.f;
      if (r < nrows && c < ncols) v = sr[c] / l;
      __syncwarp();
      if (c < ncols16) pr[c] = __float2bfloat16_rn(v);
      __syncwarp();
    }
  }

  // values: warp -> (output column tile t, key-block share sp)
  const int ntiles = Dp / 16, nsplit = NWARPS / ntiles;
  const int t = warp % ntiles, sp = warp / ntiles;
  const bool busy = sp < nsplit;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int k0 = 0; k0 < ncols16; k0 += KT) {
    __syncthreads();
    load_rows_bf16(V + (size_t)k0 * hd, hd, min(KT, ncols - k0), KT, D, Dp,
                   kv);
    __syncthreads();
    if (!busy) continue;
    for (int kb = sp; kb < KT / 16 && k0 + 16 * kb < ncols16; kb += nsplit) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p + k0 + 16 * kb, 2 * Lk);
      wmma::load_matrix_sync(fb, kv + 16 * kb * Dp + 16 * t, Dp);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  if (busy)
    wmma::store_matrix_sync(part + (size_t)sp * ROWS * Dp + 16 * t, acc, Dp,
                            wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.out) +
                     ((size_t)b * a.Lq + row0) * hd + (size_t)h * D;
  for (int i = threadIdx.x; i < nrows * D; i += NTHREADS) {
    const int r = i / D, d = i - r * D;
    float v = 0.f;
    for (int j = 0; j < nsplit; ++j)
      v += part[((size_t)j * ROWS + r) * Dp + d];
    O[(size_t)r * hd + d] = __float2bfloat16_rn(v);
  }
}

// ---- launch -------------------------------------------------------------

static size_t smem_bytes(int Lk, int D) {
  const size_t Dp = (D + 15) & ~15;
  return 4 * (size_t)ROWS * Lk + 2 * (size_t)ROWS * Dp +
         2 * (size_t)KT * Dp + 4 * (size_t)PART_FLOATS;
}

extern "C" {

// The kernel's constants and shared-memory size, so the wrapper sizes and
// checks alike.
int faf_rows() { return ROWS; }
int faf_max_d() { return MAX_D; }
long long faf_smem_bytes(int Lk, int D) {
  return (long long)smem_bytes(Lk, D);
}

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 when
// it was accepted), or cudaErrorInvalidValue for arguments the kernel does
// not take. The wrapper has checked shapes, the bf16 type, contiguity and
// 16-byte alignment.
int faf_launch(const void* q, const void* k, const void* v, void* out, int B,
               int Lq, int Lk, int H, int D, int kv_valid, int causal,
               void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 8 || D > MAX_D || D % 8 ||
      kv_valid < 1 || kv_valid > Lk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.D = D;
  a.kv_valid = kv_valid; a.causal = causal ? 1 : 0;
  const size_t smem = smem_bytes(Lk, D);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(faf_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + ROWS - 1) / ROWS, H, B), block(NTHREADS);
  faf_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a, (D + 15) & ~15);
  return (int)cudaGetLastError();
}

const char* faf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
