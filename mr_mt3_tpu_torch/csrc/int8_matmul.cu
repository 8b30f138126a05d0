// Int8-weight products of the 'int8' decode tier for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of mr_mt3_tpu/ops/int8_matmul.py:
//   * int8_matmul (pallas_call :71, _matmul_kernel :61), the lm_head:
//       y = (x @ W) * s, W (K, N) int8 codes, s (N,) f32 column scales;
//   * int8_gated_ff (pallas_call :108, _gated_ff_kernel :84), a decoder
//     layer's gated-GELU feed-forward in one launch:
//       a = (h @ W0) * s0,  b = (h @ W1) * s1,
//       g = bf16(gelu_new(a) * b)         (rounded whatever h's type),
//       out = (g @ Wo) * so.
// As the TPU kernels do: every sum is f32 over the codes' exact f32 values
// (x f32: f32 products; x bf16: bf16 x code products, exact in f32), each
// column scale is applied after its dot, and the output has x's type.
// gelu_new is the tanh form in f32 (models/mt3.py). Built without
// --use_fast_math, so tanhf and the products are the IEEE ones.
//
// Bound on the H100 (3.35 TB/s HBM; 989 TFLOP/s bf16): both kernels read
// their int8 weights once and do 2 flops per weight byte per row, so at
// the decode batch (B <= 64) they are bound by bytes: the lm_head (512 x
// 1536, 0.79 MB) takes at least 0.24 us, a layer's feed-forward (3 x 0.5
// MB) 0.47 us. chip_smoke.py computes the bound of each case.
//
// Design (right and simple first): one block of 256 threads owns RT = 4
// rows and CT = 64 output columns (4 rows: at the decode batch of 8, twice
// the blocks of an 8-row tile). The block's input rows sit in shared
// memory as f32. Each thread owns 4 adjacent columns (one char4 load of a
// weight row) and one of 16 interleaved slices of the K axis; the 16
// partial sums of each output are added in slice order in shared memory,
// so a result does not depend on scheduling. The K loops are unrolled so
// that several weight loads are in flight (one at a time left each thread
// waiting on L2: 0.19 ms for a feed-forward at B = 8 on an H100, against
// 0.084 ms unrolled with 4-row tiles; PERF.md). The feed-forward block first
// computes its rows' whole intermediate g (RT x d_ff, f32 in shared
// memory; it never goes to HBM): each thread owns 4 intermediate columns
// over the full D axis, a first pass keeps a, a second combines it with b.
// Every column block recomputes g, so W0 and W1 are read from HBM once and
// then from the 50 MB L2. Not done yet: tensor cores (mma int8 or bf16),
// copies overlapped with the sums, a split of the up-projection across
// blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NTHREADS 256
#define RT 4                        // rows per block
#define CT 64                       // output columns per block
#define CG (CT / 4)                 // column groups of 4: 16
#define KS (NTHREADS / CG)          // K slices: 16

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * (x * x * x))));
}

// rows row0.. of x (B, K) into xs (RT x K, f32); rows past B are zeros
template <typename T>
__device__ void load_rows(float* xs, const T* x, int row0, int B, int K) {
  for (int i = threadIdx.x; i < RT * K; i += NTHREADS) {
    const int r = i / K, row = row0 + r;
    xs[i] = row < B ? to_f(x[(size_t)row * K + (i - r * K)]) : 0.f;
  }
}

// out[row0 + r, col0 + c] = (sum_k xs[r, k] W[k, col0 + c]) * s[col0 + c]
// for the block's RT rows and CT columns; part holds KS x RT x CT floats
template <typename T>
__device__ void tile_product(const float* xs, const int8_t* W,
                             const float* s, int K, int N, int col0,
                             float* part, T* out, int row0, int B) {
  const int cg = threadIdx.x % CG, ks = threadIdx.x / CG;
  const int c = col0 + 4 * cg;
  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  if (c < N) {
#pragma unroll 4
    for (int k = ks; k < K; k += KS) {
      const char4 w = *reinterpret_cast<const char4*>(W + (size_t)k * N + c);
      const float w0 = w.x, w1 = w.y, w2 = w.z, w3 = w.w;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xv = xs[r * K + k];
        acc[r][0] = fmaf(xv, w0, acc[r][0]);
        acc[r][1] = fmaf(xv, w1, acc[r][1]);
        acc[r][2] = fmaf(xv, w2, acc[r][2]);
        acc[r][3] = fmaf(xv, w3, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(ks * RT + r) * CT + 4 * cg + j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < RT * CT; i += NTHREADS) {
    const int r = i / CT, cc = i - r * CT;
    const int row = row0 + r, col = col0 + cc;
    if (row >= B || col >= N) continue;
    float v = 0.f;
    for (int j = 0; j < KS; ++j) v += part[(j * RT + r) * CT + cc];
    store(out + (size_t)row * N + col, v * s[col]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    i8mm_kernel(const T* x, const int8_t* w, const float* s, T* out, int B,
                int K, int N) {
  extern __shared__ float sm[];
  float* xs = sm;                   // RT x K
  float* part = xs + RT * K;        // KS x RT x CT
  const int row0 = blockIdx.y * RT, col0 = blockIdx.x * CT;
  load_rows(xs, x, row0, B, K);
  __syncthreads();
  tile_product(xs, w, s, K, N, col0, part, out, row0, B);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    i8ff_kernel(const T* h, const int8_t* w0, const int8_t* w1,
                const int8_t* wo, const float* s0, const float* s1,
                const float* so, T* out, int B, int D, int F) {
  extern __shared__ float sm[];
  float* hs = sm;                   // RT x D
  float* gs = hs + RT * D;          // RT x F: the intermediate g
  float* part = gs + RT * F;        // KS x RT x CT
  const int row0 = blockIdx.y * RT, col0 = blockIdx.x * CT;
  load_rows(hs, h, row0, B, D);
  __syncthreads();
  for (int f = 4 * threadIdx.x; f < F; f += 4 * NTHREADS) {
    float acc[RT][4];
    for (int pass = 0; pass < 2; ++pass) {
      const int8_t* W = pass ? w1 : w0;
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        const char4 w = *reinterpret_cast<const char4*>(W + (size_t)k * F + f);
        const float q0 = w.x, q1 = w.y, q2 = w.z, q3 = w.w;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float hv = hs[r * D + k];
          acc[r][0] = fmaf(hv, q0, acc[r][0]);
          acc[r][1] = fmaf(hv, q1, acc[r][1]);
          acc[r][2] = fmaf(hv, q2, acc[r][2]);
          acc[r][3] = fmaf(hv, q3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* g = gs + r * F + f + j;
          if (pass == 0) {
            *g = acc[r][j] * s0[f + j];                       // a
          } else {
            const float b = acc[r][j] * s1[f + j];
            *g = __bfloat162float(__float2bfloat16_rn(gelu_new(*g) * b));
          }
        }
    }
  }
  __syncthreads();
  tile_product(gs, wo, so, F, D, col0, part, out, row0, B);
}

// ---- launch -------------------------------------------------------------

static size_t smem_mm(int K) {
  return 4 * ((size_t)RT * K + (size_t)KS * RT * CT);
}

static size_t smem_ff(int D, int F) {
  return 4 * ((size_t)RT * D + (size_t)RT * F + (size_t)KS * RT * CT);
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" {

// y (B, N) = (x (B, K) @ w (K, N)) * s (N,), x and y of `dtype` (DType).
// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for arguments the kernel does not take (a K or,
// for the feed-forward, a D + F past the shared memory a block can opt
// into among them). The wrapper has checked shapes, types, contiguity and
// 4-byte alignment.
int i8mm_launch(const void* x, const void* w, const void* s, void* out,
                int B, int K, int N, int dtype, void* stream) {
  if (B < 1 || K < 1 || N < 4 || N % 4 || (dtype != DT_F32 &&
      dtype != DT_BF16) || (B + RT - 1) / RT > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_mm(K);
  const dim3 grid((N + CT - 1) / CT, (B + RT - 1) / RT), block(NTHREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == DT_F32) {
    err = allow_smem(i8mm_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    i8mm_kernel<float><<<grid, block, smem, st>>>(
        (const float*)x, (const int8_t*)w, (const float*)s, (float*)out, B,
        K, N);
  } else {
    err = allow_smem(i8mm_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    i8mm_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)s,
        (__nv_bfloat16*)out, B, K, N);
  }
  return (int)cudaGetLastError();
}

// out (B, D) = gated-GELU feed-forward of h (B, D): w0, w1 (D, F), wo
// (F, D) int8, s0, s1 (F,), so (D,) f32; h and out of `dtype`.
int i8ff_launch(const void* h, const void* w0, const void* w1,
                const void* wo, const void* s0, const void* s1,
                const void* so, void* out, int B, int D, int F, int dtype,
                void* stream) {
  if (B < 1 || D < 4 || F < 4 || D % 4 || F % 4 || (dtype != DT_F32 &&
      dtype != DT_BF16) || (B + RT - 1) / RT > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_ff(D, F);
  const dim3 grid((D + CT - 1) / CT, (B + RT - 1) / RT), block(NTHREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == DT_F32) {
    err = allow_smem(i8ff_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    i8ff_kernel<float><<<grid, block, smem, st>>>(
        (const float*)h, (const int8_t*)w0, (const int8_t*)w1,
        (const int8_t*)wo, (const float*)s0, (const float*)s1,
        (const float*)so, (float*)out, B, D, F);
  } else {
    err = allow_smem(i8ff_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    i8ff_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        (const __nv_bfloat16*)h, (const int8_t*)w0, (const int8_t*)w1,
        (const int8_t*)wo, (const float*)s0, (const float*)s1,
        (const float*)so, (__nv_bfloat16*)out, B, D, F);
  }
  return (int)cudaGetLastError();
}

const char* i8mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
