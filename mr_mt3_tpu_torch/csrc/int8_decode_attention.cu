// One-query decode attention over an int8 K/V cache for NVIDIA Hopper
// (sm_90a), the 'int8_kv' decode tier.
//
// Replaces the TPU kernel mr_mt3_tpu/ops/int8_attention.py::
// int8_decode_attention (pallas_call :101, _attention_kernel :57). Per
// (batch row b, head h), as the TPU kernel computes it:
//   1. q (dk values, f32 or bf16, read as f32) quantized to int8:
//      qs = max(max|q|, 1e-12) / 127, qi = clip(rint(q / qs), -127, 127);
//   2. s_i32[k] = sum_d qi[d] kq[d, k], exact int32;
//   3. s[k] = float(s_i32[k]) * qs * ks[k]  (ks the position's K scale);
//   4. positions k > position are masked (-1e9 in the TPU kernel);
//   5. p = exp(s - max s) / sum exp(s - max s), f32;
//   6. pv[k] = p[k] * vs[k]  (vs the position's V scale);
//   7. ps = max(max|pv|, 1e-20) / 127, pi = clip(rint(pv / ps), -127, 127);
//   8. out[d] = float(sum_k pi[k] vq[d, k]) * ps, exact int32 sum, in q's
//      type.
// A masked position's exp(-1e9 - max) is exactly 0, so it adds nothing to
// the sum, leaves max|pv| alone and quantizes to code 0: the kernel stops
// at `position` and never reads the cache past it, and a cache of any
// length >= position + 1 gives the same result (the TPU loop grows its
// cache in 64-step phases). rintf rounds half to even, as jnp.round does;
// built without --use_fast_math, so expf and the divisions are the IEEE
// ones.
//
// Layout, the JAX package's: q (B, H, dk); kq, vq (B, H, dk, K) int8, the
// positions contiguous; ks, vs (B, H, 1, K) f32; out (B, H * dk). K is a
// multiple of 4 (the port allocates its caches so).
//
// Bound on the H100 (3.35 TB/s HBM; 1,979 TOP/s int8): a call reads
// 2 x dk + 8 bytes per cached position and head and does 4 x dk integer
// operations per position: bound by bytes. At B = 8, H = 6, dk = 64 over
// 1024 positions it moves 6.7 MB, at least 2.0 us. chip_smoke.py computes
// the bound of each case.
//
// Design (right and simple first): one block of 256 threads per (head,
// batch row). Scores: each thread owns 4 adjacent positions and walks the
// dk rows of K with one char4 load per row (a warp reads 128 contiguous
// bytes), integer multiply-adds. The f32 scores, then pv, stay in shared
// memory; max and sum are block reductions in a fixed order (each thread's
// positions in order, then a shuffle tree, then the warps in order), so a
// result does not depend on scheduling. Values: the requantized
// probabilities are packed 4 to an int; each warp owns rows d of V and
// takes __dp4a over 4 positions per lane, then a shuffle sum (integers:
// exact in any order). Not done yet: several heads or rows per block for
// short caches, and splitting a long cache across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define MAX_DK 128     // head width limit (the wrapper checks it)

enum DType { DT_F32 = 0, DT_BF16 = 1 };

struct Args {
  const void* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  void* out;
  int B, H, dk, K, n;   // n = position + 1 positions attended
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int quant(float x, float s) {
  return (int)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's max (or sum) of v; every thread gets it
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();                  // red is free (an earlier reduce read it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) i8att_kernel(Args a) {
  extern __shared__ float sc[];     // n4 floats: scores, then pv
  __shared__ float qf[MAX_DK];
  __shared__ int qi[MAX_DK];
  __shared__ float red[NWARPS];
  const int h = blockIdx.x, b = blockIdx.y;
  const int dk = a.dk, K = a.K, n = a.n, n4 = (n + 3) & ~3;
  const size_t bh = (size_t)b * a.H + h;
  int* pq = reinterpret_cast<int*>(sc + n4);   // n4 / 4 packed codes

  // 1. q per (row, head) to int8
  const T* q = static_cast<const T*>(a.q) + bh * dk;
  float m = 0.f;
  for (int d = threadIdx.x; d < dk; d += NTHREADS) {
    qf[d] = to_f(q[d]);
    m = fmaxf(m, fabsf(qf[d]));
  }
  const float qs = fmaxf(block_reduce(m, red, true), 1e-12f) / 127.f;
  for (int d = threadIdx.x; d < dk; d += NTHREADS) qi[d] = quant(qf[d], qs);
  __syncthreads();

  // 2-4. integer scores of positions < n, rescaled
  const int8_t* kq = a.kq + bh * dk * (size_t)K;
  const float* ks = a.ks + bh * K;
  float mx = -INFINITY;
  for (int p = 4 * threadIdx.x; p < n; p += 4 * NTHREADS) {
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 8
    for (int d = 0; d < dk; ++d) {
      const char4 k4 = *reinterpret_cast<const char4*>(kq + (size_t)d * K + p);
      const int qd = qi[d];
      s0 += qd * k4.x;
      s1 += qd * k4.y;
      s2 += qd * k4.z;
      s3 += qd * k4.w;
    }
    const int s[4] = {s0, s1, s2, s3};
    for (int j = 0; j < 4 && p + j < n; ++j) {
      const float v = (float)s[j] * qs * ks[p + j];
      sc[p + j] = v;
      mx = fmaxf(mx, v);
    }
  }
  mx = block_reduce(mx, red, true);

  // 5. softmax over positions < n
  float sum = 0.f;
  for (int p = 4 * threadIdx.x; p < n; p += 4 * NTHREADS)
    for (int j = 0; j < 4 && p + j < n; ++j) {
      const float e = expf(sc[p + j] - mx);
      sc[p + j] = e;
      sum += e;
    }
  sum = block_reduce(sum, red, false);

  // 6-7. fold in the V scales, requantize
  const float* vs = a.vs + bh * K;
  float pm = 0.f;
  for (int p = 4 * threadIdx.x; p < n; p += 4 * NTHREADS)
    for (int j = 0; j < 4 && p + j < n; ++j) {
      const float pv = sc[p + j] / sum * vs[p + j];
      sc[p + j] = pv;
      pm = fmaxf(pm, fabsf(pv));
    }
  const float ps = fmaxf(block_reduce(pm, red, true), 1e-20f) / 127.f;
  for (int p = 4 * threadIdx.x; p < n4; p += 4 * NTHREADS) {
    unsigned packed = 0;
    for (int j = 0; j < 4; ++j) {
      const int c = p + j < n ? quant(sc[p + j], ps) : 0;
      packed |= (unsigned)(c & 0xff) << (8 * j);
    }
    pq[p >> 2] = (int)packed;
  }
  __syncthreads();

  // 8. value sums: a warp per V row, 4 positions per lane per __dp4a
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* vq = a.vq + bh * dk * (size_t)K;
  T* out = static_cast<T*>(a.out) + bh * dk;
  for (int d = warp; d < dk; d += NWARPS) {
    const int* row = reinterpret_cast<const int*>(vq + (size_t)d * K);
    int acc = 0;
    for (int g = lane; g < n4 / 4; g += 32) acc = __dp4a(pq[g], row[g], acc);
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) store(out + d, (float)acc * ps);
  }
}

// ---- launch -------------------------------------------------------------

static size_t smem_bytes(int n) {
  const size_t n4 = (size_t)((n + 3) & ~3);
  return 4 * n4 + n4;               // f32 scores + packed int8 codes
}

extern "C" {

int i8att_max_dk() { return MAX_DK; }

// out (B, H * dk) = attention of q (B, H, dk) over positions 0..position
// of kq, vq (B, H, dk, K) int8 with scales ks, vs (B, H, 1, K) f32; q and
// out of `dtype` (DType). Returns cudaGetLastError() after the launch (0
// when it was accepted), or cudaErrorInvalidValue for arguments the
// kernel does not take, a cache span past the shared memory a block can
// opt into among them. The wrapper has checked shapes, types, contiguity
// and alignment.
int i8att_launch(const void* q, const void* kq, const void* ks,
                 const void* vq, const void* vs, void* out, int B, int H,
                 int dk, int K, int position, int dtype, void* stream) {
  if (B < 1 || H < 1 || dk < 1 || dk > MAX_DK || K < 4 || K % 4 ||
      position < 0 || position >= K || B > 65535 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.kq = (const int8_t*)kq; a.ks = (const float*)ks;
  a.vq = (const int8_t*)vq; a.vs = (const float*)vs; a.out = out;
  a.B = B; a.H = H; a.dk = dk; a.K = K; a.n = position + 1;
  const size_t smem = smem_bytes(a.n);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + 4 * (2 * MAX_DK + NWARPS) > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B), block(NTHREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) {
    err = cudaFuncSetAttribute(i8att_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    i8att_kernel<float><<<grid, block, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(i8att_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    i8att_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* i8att_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
