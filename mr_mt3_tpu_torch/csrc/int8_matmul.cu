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
// int8_matmul: tasks of 16 columns (one 16-byte vector of a W row) x RT
// rows (8 up to 8 rows, else 16). Where the tasks fit the SMs a block
// takes one (the lm_head at B 8: 96 blocks over 96 SMs, each weight read
// once); past that a block an SM owns a row tile and walks its column
// units, Q groups of 128 threads summing Q of them at once (B 64:
// 132 blocks of three groups, one round), so x is copied once a block and
// an SM has 4 Q warps to issue from. A task's codes and x rows go to
// shared memory by cp.async, all in flight at once (x through L1, which
// the H100 serves faster where every SM reads the same lines), a group's
// next unit in flight while it sums the current one. The sums take
// cuBLAS's order for the plain version's products at B 8 (as int8_gated_ff
// does): chunks of 64 k's, each a sequence of fused multiply-adds from
// zero, the chunks added in order, then the scale; a half-warp owns a chunk
// at a time, a thread 4 columns x RT / 4 rows of it, its codes turned into
// floats in registers (a shared f32 copy of them made the sums wait on
// shared memory's bandwidth) and bf16 x widened as it is read. No tensor
// cores: a bf16 mma would round f32 x, and its sums are not a sequence of
// FMAs. On the H100 bound by latency at B 8 (~4 us against ~1.2 us for
// an empty launch and ~1.9 us for a kernel that only reads the codes at
// this grid: probes/int8_kernels.py), by instruction issue at B 64. K is
// bounded by shared memory (~1800 at 16 rows in f32).
//
// int8_gated_ff: one cooperative launch of up to one block an SM. Phase
// 1 deals tasks of 16 columns (one 16-byte vector of a W row) and 8 rows
// over the blocks, so each column of W0 and W1 is read and summed once
// per row tile, over many SMs; a task writes its g, bf16, to a B x F
// scratch (16 KB at B = 8, in L2). A grid barrier (its counter left as it
// was found; the launch is captured into the step loop's CUDA graphs as
// it is, the words of the capture stream allocated before the capture).
// Phase 2 deals tasks of 16 columns of Wo and 8 rows, each
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
// the same with 16 bytes through L1 too (.ca): where many SMs read the
// same lines at once (x in int8_matmul), faster on the H100 (PERF.md)
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
  else
    cp_async(dst, src, bytes);
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

// ---- int8_matmul ----------------------------------------------------------

#define MM_THREADS 128              // 8 half-warps, one chunk each at a time
#define MM_HALVES (MM_THREADS / 16)
#define MM_UNIT 16                  // columns a task: 16 bytes of a W row
#define MM_CHUNK 64                 // k's of a chunk: cuBLAS's order
#define MM_SKEW 16                  // elements after each chunk of a row of x
                                    // in shared memory (a row of 16 bytes
                                    // after each chunk of the codes): the
                                    // half-warps of a warp, on chunks c and
                                    // c + 1, read other banks

struct MMArgs {
  const void* x;
  const int8_t* w;
  const float* s;
  void* out;
  int B, K, N;
  int ww;   // bytes a copy of a W row: 16, 8 or 4
  int xw;   // bytes a copy of x: 16, 8 or 4; 0: bf16 read one by one
};

// Shared memory of i8mm_kernel at RT rows a task and Q units at once, in
// this order: the block's x rows in x's type, a row's chunks MM_SKEW
// elements apart and the rows mm_ld elements apart (16 bytes more than a
// multiple of 128 in bf16, 4 floats more than one of 32 in f32, so the
// four row groups of a half-warp read other banks); two buffers of a
// unit's codes for each of the Q, K rows of 16 bytes and a spare row after
// each chunk; the chunks' sums of each.
__host__ __device__ inline int mm_chunks(int K) {
  return (K + MM_CHUNK - 1) / MM_CHUNK;
}
__host__ __device__ inline int mm_ld(int K, int elt) {
  const int span = elt == 4 ? 32 : 64;
  return (mm_chunks(K) * (MM_CHUNK + MM_SKEW) + span - 1) / span * span +
         16 / elt;
}
__host__ __device__ inline int mm_wbytes(int K) {
  return (K + mm_chunks(K)) * MM_UNIT;
}
__host__ __device__ inline int mm_red(int RT, int K) {   // floats
  return mm_chunks(K) * RT * MM_UNIT;
}
__host__ __device__ inline size_t mm_smem(int RT, int K, int elt, int Q) {
  return (size_t)elt * RT * mm_ld(K, elt) + 2 * (size_t)Q * mm_wbytes(K) +
         sizeof(float) * (size_t)Q * mm_red(RT, K);
}

// element t of v (t a constant once unrolled)
__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// x[k .. k + 3] as floats (bf16 widened exactly: its bits are a float's
// upper half)
__device__ __forceinline__ float4 mm_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 mm_x4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// k .. k + 3 of a thread's chunk sums: its R rows of x (4 i rows apart)
// at xp, its word of 4 codes a k at cp, the codes turned into floats in
// registers (a shared-memory copy of them as f32 made the sums wait on
// shared memory's bandwidth)
template <int R, typename T>
__device__ __forceinline__ void mm_step(const T* xp, const int8_t* cp,
                                        int ld, int k, float (&acc)[R][4]) {
  float4 xv[R];
  unsigned wd[4];
#pragma unroll
  for (int i = 0; i < R; ++i) xv[i] = mm_x4(xp + 4 * i * ld + k);
#pragma unroll
  for (int t = 0; t < 4; ++t)
    wd[t] = *reinterpret_cast<const unsigned*>(cp + (k + t) * MM_UNIT);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float w[4];
    codes_to_f(wd[t], w);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        acc[i][cc] = fmaf(lane_of(xv[i], t), w[cc], acc[i][cc]);
  }
}

// where k of a row of x lies in shared memory (in elements)
__device__ __forceinline__ int mm_k(int k) {
  return k + MM_SKEW * (k / MM_CHUNK);
}

// columns [16 u, 16 u + 16) of the K x N codes (those < N) into dst, row
// k at (k + k / MM_CHUNK) * 16, by the MM_THREADS threads t of a group
__device__ __forceinline__ void mm_copy_unit(int8_t* dst, const int8_t* w,
                                             int K, int N, int u, int ww,
                                             int t) {
  const int col0 = MM_UNIT * u, ncol = min(MM_UNIT, N - col0);
  for (int k = t; k < K; k += MM_THREADS)
    for (int b = 0; b < ncol; b += ww)
      cp_async(dst + (k + k / MM_CHUNK) * MM_UNIT + b,
               w + (size_t)k * N + col0 + b, ww);
}

// A block owns a row tile [r0, r0 + RT), RT = 4 R, and the column units
// u0 = blockIdx.x / tiles, u0 + stride, u0 + 2 stride, ... (stride =
// gridDim.x / tiles; one unit a block where the tasks fit the SMs). Its Q
// groups of 128 threads (Q = blockDim.x / 128) sum Q of them at once,
// group q the q-th of each round, so an SM keeps Q x 4 warps busy. The x
// rows go to shared memory once (in x's type; rows past B zero), each
// unit's codes by cp.async, a group's next unit in
// flight while it sums the current one. In a group, half-warp h sums
// chunks h, h + 8, ..., a thread (rg, j) the rows rg + 4 i (i < R) and the
// columns 4 j .. 4 j + 3 of a chunk, each a sequence of fused
// multiply-adds from zero; then the chunks' sums are added in chunk order,
// the scale applied, and x's type stored.
template <typename T, int R>
__global__ void __launch_bounds__(4 * MM_THREADS) i8mm_kernel(MMArgs a) {
  constexpr int RT = 4 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, N = a.N, C = mm_chunks(K), ld = mm_ld(K, sizeof(T));
  const int wbytes = mm_wbytes(K), tid = threadIdx.x, nt = blockDim.x;
  const int Q = nt / MM_THREADS, q = tid / MM_THREADS, t = tid % MM_THREADS;
  T* xs = reinterpret_cast<T*>(smem);                         // RT x ld
  int8_t* wbuf = reinterpret_cast<int8_t*>(xs + RT * ld);     // Q x 2 x wbytes
  float* red = reinterpret_cast<float*>(wbuf + 2 * Q * wbytes);
  int8_t* wq = wbuf + 2 * q * wbytes;          // the group's two buffers
  float* rq = red + q * mm_red(RT, K);         // its C x RT x 16 sums
  const int tiles = (a.B + RT - 1) / RT, units = (N + MM_UNIT - 1) / MM_UNIT;
  const int stride = gridDim.x / tiles, r0 = (blockIdx.x % tiles) * RT;
  const int nr = min(RT, a.B - r0), u0 = blockIdx.x / tiles;
  const T* x = static_cast<const T*>(a.x) + (size_t)r0 * K;

  // the x rows (rows past B zero) and each group's first unit
  int u = u0 + q * stride;
  if (u < units) mm_copy_unit(wq, a.w, K, N, u, a.ww, t);
  const int per = a.xw / (int)sizeof(T);
  for (int r = 0; r < nr; ++r)
    if (per)
      for (int k = tid * per; k < K; k += nt * per)
        cp_async_ca(xs + r * ld + mm_k(k), x + (size_t)r * K + k, a.xw);
    else
      for (int k = tid; k < K; k += nt) xs[r * ld + mm_k(k)] = x[r * K + k];
  for (int r = nr; r < RT; ++r)
    for (int k = tid; k < K; k += nt) xs[r * ld + mm_k(k)] = T(0.f);
  cp_async_commit();

  const int oc = t % MM_UNIT, j = t & 3, rg = (t >> 2) & 3;
  // rounds while group 0 has a unit, so every thread meets each barrier
  for (int buf = 0; u - q * stride < units; u += Q * stride, buf ^= 1) {
    const bool mine = u < units;
    const int col0 = MM_UNIT * u, ncol = mine ? min(MM_UNIT, N - col0) : 0;
    const float sv = oc < ncol ? a.s[col0 + oc] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    if (u + Q * stride < units)
      mm_copy_unit(wq + (buf ^ 1) * wbytes, a.w, K, N, u + Q * stride, a.ww,
                   t);
    cp_async_commit();

    // the chunks' sums
    const int8_t* wb = wq + buf * wbytes;
    for (int c = mine ? t >> 4 : C; c < C; c += MM_HALVES) {
      const int n = min(MM_CHUNK, K - c * MM_CHUNK);
      const T* xp = xs + rg * ld + c * (MM_CHUNK + MM_SKEW);
      const int8_t* cp = wb + c * (MM_CHUNK + 1) * MM_UNIT + 4 * j;
      float acc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[i][cc] = 0.f;
      if (n == MM_CHUNK) {   // unrolled, so the loads run ahead of the sums
#pragma unroll
        for (int k = 0; k < MM_CHUNK; k += 4)
          mm_step<R, T>(xp, cp, ld, k, acc);
      } else {
        int k = 0;
        for (; k + 4 <= n; k += 4) mm_step<R, T>(xp, cp, ld, k, acc);
        for (; k < n; ++k) {
          float w[4];
          codes_to_f(*reinterpret_cast<const unsigned*>(cp + k * MM_UNIT), w);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[i][cc] = fmaf(to_f(xp[4 * i * ld + k]), w[cc],
                                acc[i][cc]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          rq[(c * RT + rg + 4 * i) * MM_UNIT + 4 * j + cc] = acc[i][cc];
    }
    __syncthreads();

    // the chunks in order, the scale, the store
    for (int o = t; o < RT * MM_UNIT; o += MM_THREADS) {
      const int r = o / MM_UNIT;
      if (r >= nr || oc >= ncol) continue;
      float v = rq[o];
#pragma unroll 8
      for (int c = 1; c < C; ++c) v += rq[c * RT * MM_UNIT + o];
      store(static_cast<T*>(a.out) + (size_t)(r0 + r) * N + col0 + oc,
            v * sv);
    }
  }
}

// ---- launch -------------------------------------------------------------

// The card's SM count and the shared memory a block can opt into, asked
// once a device at its first launch and kept: a launch being captured
// into a CUDA graph then makes no query
#define MAX_DEVICES 64
struct DeviceInfo {
  int dev, sms, optin;
};

static cudaError_t device_info(DeviceInfo* info) {
  static DeviceInfo known[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[dev].sms == 0) {
    DeviceInfo d;
    d.dev = dev;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    known[dev] = d;
  }
  *info = known[dev];
  return cudaSuccess;
}

// Let `kernel` take smem bytes of dynamic shared memory: the attribute is
// set the first time a launch of the kernel needs more than it was granted
// (per device, `granted` the kernel's own), so a graph captured after a
// launch of the same shape sets nothing
template <typename Kernel>
static cudaError_t allow_smem(Kernel* kernel, size_t smem,
                              size_t* granted) {
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)info.optin) return cudaErrorInvalidValue;
  if (smem <= granted[info.dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) granted[info.dev] = smem;
  return err;
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

// the feed-forward kernel's resident blocks an SM at smem bytes, asked at
// the first launch of each shared-memory size (per device) and kept
template <typename T>
static cudaError_t ff_blocks_per_sm(int dev, size_t smem, int* per_sm) {
  static size_t asked[MAX_DEVICES];
  static int blocks[MAX_DEVICES];
  if (asked[dev] != smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[dev], i8ff_kernel<T>, FF_THREADS, smem);
    if (err != cudaSuccess) return err;
    asked[dev] = smem;
  }
  *per_sm = blocks[dev];
  return cudaSuccess;
}

template <typename T>
static cudaError_t ff_grid(const FFArgs& a, cudaStream_t st) {
  static size_t granted[MAX_DEVICES];
  const size_t smem = ff_smem(a.D, a.F, a.Fp, sizeof(T));
  cudaError_t err = allow_smem(i8ff_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  DeviceInfo info;
  int per_sm = 0;
  err = device_info(&info);
  if (err == cudaSuccess) err = ff_blocks_per_sm<T>(info.dev, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int sms = info.sms;
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

// R = 2 (8 rows a task) up to 8 rows, else R = 4. One block a task where
// the tasks fit the SMs; past that one block an SM (tiles divides the
// grid), its Q groups (up to 4, as many as shared memory holds) summing as
// many of its units at once
template <typename T, int R>
static cudaError_t mm_grid(const MMArgs& a, cudaStream_t st) {
  static size_t granted[MAX_DEVICES];
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  const int sms = info.sms, optin = info.optin;
  const long long tiles = (a.B + 4 * R - 1) / (4 * R);
  const long long units = (a.N + MM_UNIT - 1) / MM_UNIT;
  const long long grid = tiles * units <= sms ? tiles * units
                         : tiles >= sms ? tiles : sms / tiles * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long each = (units + grid / tiles - 1) / (grid / tiles);
  int Q = each < 4 ? (int)each : 4;
  while (Q > 1 && mm_smem(4 * R, a.K, sizeof(T), Q) > (size_t)optin) --Q;
  const size_t smem = mm_smem(4 * R, a.K, sizeof(T), Q);
  err = allow_smem(i8mm_kernel<T, R>, smem, granted);
  if (err != cudaSuccess) return err;
  i8mm_kernel<T, R><<<(unsigned)grid, Q * MM_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t mm_rows(const MMArgs& a, cudaStream_t st) {
  return a.B <= 8 ? mm_grid<T, 2>(a, st) : mm_grid<T, 4>(a, st);
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
      dtype != DT_BF16) || (uintptr_t)w % 4)
    return (int)cudaErrorInvalidValue;
  MMArgs a;
  a.x = x; a.w = (const int8_t*)w; a.s = (const float*)s; a.out = out;
  a.B = B; a.K = K; a.N = N;
  a.ww = widest_copy(N, (uintptr_t)w);
  // a row of x in whole 4-byte words on a 4-byte boundary (f32 always)
  const int row = K * (dtype == DT_F32 ? 4 : 2);
  a.xw = row % 4 == 0 && (uintptr_t)x % 4 == 0
             ? widest_copy(row, (uintptr_t)x) : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == DT_F32 ? mm_rows<float>(a, st)
                               : mm_rows<__nv_bfloat16>(a, st));
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
