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
// int8_matmul (right and simple first): one block of 256 threads owns RT
// = 4 rows and CT = 64 output columns. The block's input rows sit in
// shared memory as f32. Each thread owns 4 adjacent columns (one char4
// load of a weight row) and one of 16 interleaved slices of the K axis;
// the 16 partial sums of each output are added in slice order in shared
// memory, so a result does not depend on scheduling. The K loops are
// unrolled so that several weight loads are in flight. Not done yet:
// tensor cores, copies overlapped with the sums.
//
// int8_gated_ff: one cooperative launch of up to one block an SM. Phase
// 1 deals tasks of 16 columns (one 16-byte vector of a W row) and 8 rows
// over the blocks, so each column of W0 and W1 is read and summed once
// per row tile, over many SMs; a task writes its g, bf16, to a B x F
// scratch (16 KB at B = 8, in L2). A grid barrier (its counter left as it
// was found). Phase 2 deals tasks of 16 columns of Wo and 8 rows, each
// reading its rows of g back. A task's weights and rows go to shared
// memory with cp.async: a block copies its first task of both phases when
// it starts and the next task of a phase while it computes the current
// one (a load used in the iteration that issued it costs a round trip a
// load: PERF.md). A task's sums take cuBLAS's order for these
// shapes (ff_chunk_partials): chunks of 64 k's, each a sequence of fused
// multiply-adds, the chunks added in order; a thread owns 2 rows x 4
// columns of a chunk, the codes turned into floats with a byte permute and
// one add. g is rounded to bf16 where the plain version rounds it, each
// scale applied after its dot. A cluster of 16 blocks a row tile
// exchanging g through distributed shared memory was measured beside it
// and lost (PERF.md). Bound by latency, not bytes: ~13 us at B = 8
// against 0.48 us of bytes.

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

// ---- int8_gated_ff --------------------------------------------------------

#define FF_THREADS 256
#define FF_RT 8                     // rows a task
#define FF_UNIT 16                  // columns a task: 16 bytes of a W row
#define FF_CHUNK 64                 // k's of a chunk: cuBLAS's order
#define SPIN_LIMIT_NS 4000000000ull

struct FFArgs {
  const void* h;
  const int8_t* w0;
  const int8_t* w1;
  const int8_t* wo;
  const float* s0;
  const float* s1;
  const float* so;
  void* out;
  __nv_bfloat16* g;   // the intermediate, B x Fp bf16
  unsigned* bar;      // the grid barrier's two words
  int B, D, F, Fp;    // Fp: a row of g, F rounded up to 8
  int cw, xw;         // bytes a weight copy (16, 8, 4), an h row copy
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x bytes (a multiple of w) from src, row stride ld, into dst, row
// stride dst_ld, w bytes a copy
__device__ __forceinline__ void copy_rows(void* dst, int dst_ld,
                                          const void* src, size_t ld,
                                          int rows, int bytes, int w) {
  const int per = bytes / w;
  for (int i = threadIdx.x; i < rows * per; i += FF_THREADS) {
    const int r = i / per, c = (i - r * per) * w;
    cp_async(static_cast<char*>(dst) + (size_t)r * dst_ld + c,
             static_cast<const char*>(src) + r * ld + c, w);
  }
}

// columns [16 u, 16 u + 16) of the K x N int8 matrix W (those < N) into
// dst, K rows of 16 bytes
__device__ __forceinline__ void copy_unit(int8_t* dst, const int8_t* W,
                                          int K, int N, int u, int w) {
  copy_rows(dst, FF_UNIT, W + FF_UNIT * u, N, K,
            min(FF_UNIT, N - FF_UNIT * u), w);
}

// four int8 codes of a word -> exact floats: each byte, biased by 128, is
// the low byte of the float 2^23 + byte, less 2^23 + 128 (two operations
// a code, where I2F runs at a quarter of the FMA rate)
__device__ __forceinline__ void codes_to_f(unsigned w, float c[4]) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = __int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7440 | i)) -
           8388736.f;
}

// sum_k xs[k][r] W[k][c] for the FF_RT rows r and FF_UNIT columns c of a
// task (xs K x FF_RT f32, ws K x FF_UNIT int8), in cuBLAS's order for
// these shapes: each chunk of FF_CHUNK k's a sequence of fused
// multiply-adds from zero, the chunks' sums then added in chunk order
// (read on the H100 for the plain version's products, 512 x 1024 at
// B 8 and 9: equal bit for bit in every output; PERF.md), so a and
// b, and the g rounded from them, are the plain version's wherever its
// product takes that order. Threads [0, nthr) of the caller, nthr a
// multiple of 16: a thread owns 2 rows x 4 columns (one word of a W row)
// of a chunk, chunks dealt over the thread groups of 16; the chunk sums
// go to red (chunk x 128 floats), and ff_chunk_sum adds them.
__device__ void ff_chunk_partials(const float* xs, const int8_t* ws, int K,
                                  float* red, int t, int nthr) {
  const int j = t & 3, rp = (t >> 2) & 3;
  for (int c = t >> 4; c * FF_CHUNK < K; c += nthr >> 4) {
    float acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
    const int k1 = min(K, (c + 1) * FF_CHUNK);
#pragma unroll 4
    for (int k = c * FF_CHUNK; k < k1; ++k) {
      float w[4];
      codes_to_f(*reinterpret_cast<const unsigned*>(ws + k * FF_UNIT + 4 * j),
                 w);
      const float2 x = *reinterpret_cast<const float2*>(xs + k * FF_RT +
                                                        2 * rp);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[0][cc] = fmaf(x.x, w[cc], acc[0][cc]);
        acc[1][cc] = fmaf(x.y, w[cc], acc[1][cc]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        red[c * 128 + (2 * rp + r) * FF_UNIT + 4 * j + cc] = acc[r][cc];
  }
}

// output o (row o / 16, column o % 16) of ff_chunk_partials: the chunks'
// sums in chunk order
__device__ __forceinline__ float ff_chunk_sum(const float* red, int K,
                                              int o) {
  float v = red[o];
  for (int c = 1; c * FF_CHUNK < K; ++c) v += red[c * 128 + o];
  return v;
}

// nr rows of n values (row stride ld elements) -> xs n x FF_RT f32, the
// rows past nr zero
template <typename T>
__device__ void rows_to_xs(const T* raw, int ld, int n, int nr, float* xs) {
  for (int i = threadIdx.x; i < FF_RT * n; i += FF_THREADS) {
    const int r = i / n, k = i - r * n;
    xs[k * FF_RT + r] = r < nr ? to_f(raw[r * ld + k]) : 0.f;
  }
}

// g = bf16(gelu_new(a * s0) * (b * s1)) of the dots' outputs
__device__ __forceinline__ float gate(float va, float vb, float sa, float sb) {
  return __bfloat162float(__float2bfloat16_rn(gelu_new(va * sa) * (vb * sb)));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A grid barrier that leaves its counter as it found it: bar[0] counts the
// blocks that arrived, bar[1] is the generation. Thread 0 reads the
// generation, arrives (acquire-release at gpu scope, after __syncthreads,
// so the block's writes go with it); the last block to arrive sets bar[0]
// back to 0 and advances bar[1] with release semantics, the others spin
// on bar[1] with acquire loads. A wait past SPIN_LIMIT_NS traps, so that a
// barrier some block never reaches ends the launch with an error instead
// of hanging the card. Two launches in flight at once must not share bar
// (the wrapper keeps one per stream).
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    if (atom_add_acq_rel(bar, 1u) == gridDim.x - 1) {
      st_relaxed(bar, 0u);
      st_release(bar + 1, gen + 1);
    } else {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(bar + 1) == gen)
        if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
    }
  }
  __syncthreads();
}

// shared memory of i8ff_kernel, in bytes
__host__ __device__ inline int ff_raw_bytes(int D, int Fp, int elt) {
  const int x = FF_RT * D * elt, g = FF_RT * Fp * 2;
  return ((x > g ? x : g) + 15) / 16 * 16;
}
__host__ __device__ inline size_t ff_smem(int D, int F, int Fp, int elt) {
  const int kmax = D > F ? D : F;
  const int chunks = (kmax + FF_CHUNK - 1) / FF_CHUNK;
  return (size_t)2 * 2 * FF_UNIT * D + (size_t)2 * FF_UNIT * F +
         (size_t)2 * ff_raw_bytes(D, Fp, elt) +
         sizeof(float) * ((size_t)FF_RT * kmax + (size_t)2 * chunks * 128);
}

// One cooperative launch of G <= #SMs blocks. Phase 1
// deals tasks (16 columns u of W0 and W1, 8 rows) over the blocks: a task
// computes a and b of its columns over the whole D axis and writes g, bf16,
// to the scratch. The grid barrier. Phase 2 deals tasks (16 columns of Wo,
// 8 rows): each reads its rows of g over F and writes the output. Each
// block copies its first task of both phases (weights with cp.async) when
// it starts, and the next task of a phase while it computes the current
// one (two buffers a phase).
template <typename T>
__global__ void __launch_bounds__(FF_THREADS, 1) i8ff_kernel(FFArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, F = a.F, G = gridDim.x, tid = threadIdx.x;
  const int tiles = (a.B + FF_RT - 1) / FF_RT;
  const int n1 = (F + FF_UNIT - 1) / FF_UNIT * tiles;
  const int n2 = (D + FF_UNIT - 1) / FF_UNIT * tiles;
  const int raw_bytes = ff_raw_bytes(D, a.Fp, sizeof(T));
  int8_t* w1buf = reinterpret_cast<int8_t*>(smem);   // 2 x (W0 | W1) units
  int8_t* w2buf = w1buf + 2 * 2 * FF_UNIT * D;       // 2 x Wo units
  unsigned char* raw = reinterpret_cast<unsigned char*>(w2buf) +
                       2 * FF_UNIT * F;              // 2 x rows of h or g
  float* xs = reinterpret_cast<float*>(raw + 2 * raw_bytes);
  float* red = xs + FF_RT * (D > F ? D : F);   // 2 x chunks x 128
  float* red_b = red + ((D > F ? D : F) + FF_CHUNK - 1) / FF_CHUNK * 128;
  const int r = tid >> 4, c = tid & 15;   // a task's output of thread < 128

  auto stage1 = [&](int t, int buf) {
    const int u = t / tiles, r0 = (t % tiles) * FF_RT;
    int8_t* w = w1buf + buf * 2 * FF_UNIT * D;
    copy_unit(w, a.w0, D, F, u, a.cw);
    copy_unit(w + FF_UNIT * D, a.w1, D, F, u, a.cw);
    copy_rows(raw + buf * raw_bytes, 0,
              static_cast<const T*>(a.h) + (size_t)r0 * D, 0, 1,
              min(FF_RT, a.B - r0) * D * (int)sizeof(T), a.xw);
  };
  auto stage2_w = [&](int t, int buf) {
    copy_unit(w2buf + buf * FF_UNIT * F, a.wo, F, D, t / tiles, a.cw);
  };
  auto stage2_g = [&](int t, int buf) {
    const int r0 = (t % tiles) * FF_RT;
    copy_rows(raw + buf * raw_bytes, 0, a.g + (size_t)r0 * a.Fp, 0, 1,
              min(FF_RT, a.B - r0) * a.Fp * 2, 16);
  };
  if (blockIdx.x < n1) stage1(blockIdx.x, 0);
  if (blockIdx.x < n2) stage2_w(blockIdx.x, 0);
  cp_async_commit();

  for (int t = blockIdx.x, buf = 0; t < n1; t += G, buf ^= 1) {
    const int u = t / tiles, r0 = (t % tiles) * FF_RT;
    const int col = FF_UNIT * u + c;
    const bool mine = tid < 128 && r0 + r < a.B && col < F;
    const float sa = mine ? a.s0[col] : 0.f, sb = mine ? a.s1[col] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    if (t + G < n1) stage1(t + G, buf ^ 1);
    cp_async_commit();
    rows_to_xs(reinterpret_cast<const T*>(raw + buf * raw_bytes), D, D,
               min(FF_RT, a.B - r0), xs);
    __syncthreads();
    // a on threads 0-127, b on 128-255
    const int half = FF_THREADS / 2, hi = tid >= half;
    ff_chunk_partials(xs, w1buf + buf * 2 * FF_UNIT * D + hi * FF_UNIT * D,
                      D, hi ? red_b : red, tid - hi * half, half);
    __syncthreads();
    if (mine)
      a.g[(size_t)(r0 + r) * a.Fp + col] = __float2bfloat16_rn(
          gate(ff_chunk_sum(red, D, tid), ff_chunk_sum(red_b, D, tid), sa,
               sb));
  }

  grid_barrier(a.bar);

  if (blockIdx.x < n2) stage2_g(blockIdx.x, 0);
  cp_async_commit();
  for (int t = blockIdx.x, buf = 0; t < n2; t += G, buf ^= 1) {
    const int r0 = (t % tiles) * FF_RT;
    const int col = FF_UNIT * (t / tiles) + c;
    const bool mine = tid < 128 && r0 + r < a.B && col < D;
    const float sov = mine ? a.so[col] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    if (t + G < n2) {
      stage2_w(t + G, buf ^ 1);
      stage2_g(t + G, buf ^ 1);
    }
    cp_async_commit();
    rows_to_xs(reinterpret_cast<const __nv_bfloat16*>(raw + buf * raw_bytes),
               a.Fp, F, min(FF_RT, a.B - r0), xs);
    __syncthreads();
    ff_chunk_partials(xs, w2buf + buf * FF_UNIT * F, F, red, tid,
                      FF_THREADS);
    __syncthreads();
    if (mine) store(static_cast<T*>(a.out) + (size_t)(r0 + r) * D + col,
                    ff_chunk_sum(red, F, tid) * sov);
  }
}

// ---- launch -------------------------------------------------------------

static size_t smem_mm(int K) {
  return 4 * ((size_t)RT * K + (size_t)KS * RT * CT);
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

// the widest of 16, 8 and 4 bytes that divides n and the address bits
static int widest_copy(int n, uintptr_t bits) {
  for (int w = 16; w > 4; w /= 2)
    if (n % w == 0 && bits % w == 0) return w;
  return 4;
}

static bool ff_args(FFArgs& a, const void* h, const void* w0, const void* w1,
                    const void* wo, const void* s0, const void* s1,
                    const void* so, void* out, int B, int D, int F,
                    int dtype) {
  if (B < 1 || D < 4 || F < 4 || D % 4 || F % 4 ||
      (dtype != DT_F32 && dtype != DT_BF16) ||
      ((uintptr_t)w0 | (uintptr_t)w1 | (uintptr_t)wo | (uintptr_t)h) % 4)
    return false;
  a.h = h; a.w0 = (const int8_t*)w0; a.w1 = (const int8_t*)w1;
  a.wo = (const int8_t*)wo; a.s0 = (const float*)s0;
  a.s1 = (const float*)s1; a.so = (const float*)so; a.out = out;
  a.g = nullptr; a.bar = nullptr;
  a.B = B; a.D = D; a.F = F; a.Fp = (F + 7) / 8 * 8;
  const uintptr_t wbits = (uintptr_t)w0 | (uintptr_t)w1 | (uintptr_t)wo;
  a.cw = widest_copy(D, wbits) < widest_copy(F, wbits)
             ? widest_copy(D, wbits) : widest_copy(F, wbits);
  a.xw = widest_copy(D * (dtype == DT_F32 ? 4 : 2), (uintptr_t)h);
  return true;
}

template <typename T>
static cudaError_t ff_grid(const FFArgs& a, cudaStream_t st) {
  const size_t smem = ff_smem(a.D, a.F, a.Fp, sizeof(T));
  cudaError_t err = allow_smem(i8ff_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, i8ff_kernel<T>, FF_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = (a.B + FF_RT - 1) / FF_RT;
  const int units = (a.D > a.F ? a.D : a.F) + FF_UNIT - 1;
  const long long tasks = (long long)(units / FF_UNIT) * tiles;
  const int G = tasks < (long long)sms * per_sm ? (int)tasks : sms * per_sm;
  FFArgs arg = a;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel((void*)i8ff_kernel<T>, dim3(G),
                                    dim3(FF_THREADS), args, smem, st);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

extern "C" {

// y (B, N) = (x (B, K) @ w (K, N)) * s (N,), x and y of `dtype` (DType).
// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for arguments the kernel does not take (a K, or
// for the feed-forward a D and F, past the shared memory a block can opt
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
// (F, D) int8, s0, s1 (F,), so (D,) f32; h and out of `dtype`. g is a
// scratch of B x (F rounded up to 8) bf16 and bar two 32-bit words, zero
// before the first launch that uses them and left zero by every launch;
// no two launches in flight at once may share bar. One cooperative launch
// (above). Returns as i8mm_launch does; also
// cudaErrorCooperativeLaunchTooLarge where no block fits an SM.
int i8ff_launch(const void* h, const void* w0, const void* w1,
                const void* wo, const void* s0, const void* s1,
                const void* so, void* out, int B, int D, int F, int dtype,
                void* stream, void* g, void* bar) {
  FFArgs a;
  if (!ff_args(a, h, w0, w1, wo, s0, s1, so, out, B, D, F, dtype) || !g ||
      !bar || (uintptr_t)g % 16 || (uintptr_t)bar % 4)
    return (int)cudaErrorInvalidValue;
  a.g = (__nv_bfloat16*)g;
  a.bar = (unsigned*)bar;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == DT_F32 ? ff_grid<float>(a, st)
                               : ff_grid<__nv_bfloat16>(a, st));
}

const char* i8mm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
