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
// the sum, leaves max|pv| alone and quantizes to code 0: the kernel uses
// no position past `position` (its copies may read up to the next 16-byte
// boundary of a row, inside the cache, and drop those bytes), and a cache
// of any length >= position + 1 gives the same result. rintf rounds half
// to even, as jnp.round does; built without --use_fast_math, so expf and
// the divisions are the IEEE ones.
//
// Layout, the JAX package's: q (B, H, dk); kq, vq (B, H, dk, K) int8, the
// positions contiguous; ks, vs (B, H, 1, K) f32; out (B, H * dk). K is a
// multiple of 4 (the port allocates its caches so).
//
// The position: a host int (i8att_launch), or an int32 in device memory
// (i8att_launch_dev), as the TPU kernel reads it from SMEM, so that one
// launch captured into a CUDA graph serves every position of a decode
// phase: the host sizes the launch (layout, shared memory, design) for
// n_max, the phase bound, and the kernel attends over *pos + 1 <= n_max
// positions, the loads past them dropped as above.
//
// Bound on the H100 (3.35 TB/s HBM; 1,979 TOP/s int8): a call reads
// 2 x dk + 8 bytes per cached position and head and does 4 x dk integer
// operations per position: bound by bytes. At B = 8, H = 6, dk = 64 over
// 1024 positions it moves 6.7 MB, at least 2.0 us. chip_smoke.py computes
// the bound of each case.
//
// Design. The work is a stream of bytes with little arithmetic, and on
// the H100 a dependent L2 load costs ~0.18 us and a cluster barrier ~0.7
// us (PERF.md), so each (row, head) pair stays on one block of up
// to 512 threads, and every load of a phase is issued before the first is
// used. A thread owns a group of 16 positions (one 16-byte vector of a K or V
// row; 8- or 4-byte loads where K or the pointers allow no wider: any
// K % 4 == 0 is taken, never a quiet other route) and a group of rows: at
// 1024 positions 64 position groups x 8 row groups of 8 rows, at 256
// positions 16 x 16 groups of 4. Scores: the thread's K vectors are in
// flight at once; four rows' words are transposed with byte permutes into
// 4-byte d vectors and summed with __dp4a against the packed int8 q; the row
// groups' int32 partials are added in shared memory (exact in any order).
// The V vectors are issued as soon as the K registers are free, so they
// arrive during the softmax. Softmax: the score max and max |p vs| are
// shared-memory atomicMax on order-preserving integer keys (a max is exact
// in any order), riding barriers the kernel has anyway; the sum of
// exp(s - max) is a block reduction in a fixed order (each thread's
// positions in order, a shuffle tree, the warps in order), so nothing
// depends on scheduling. Values: each row of a thread's group takes 4
// __dp4a over its 16 positions against their codes; a warp's position
// groups are added by a reduce-scatter (each halving keeps half the rows:
// 9 shuffles for 8 rows), its two warps' sums in shared memory. A
// cluster of up to 8 blocks a pair, splitting the positions and
// exchanging the max, the sum, max |p vs| and the value sums through
// distributed shared memory, was measured and lost (PERF.md). Not
// done: tensor cores, several pairs a block for short spans.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_THREADS 512
#define MAX_WARPS (MAX_THREADS / 32)
#define MAX_DK 128      // head width limit (the wrapper checks it)
#define PG_POS 16       // positions a position group: one 16-byte vector
#define MAX_PG 64       // position groups a pass: 1024 positions
#define MAX_ROWS 16     // rows of a row group (dk <= 128 over 8 groups)
#define STREAM_THREADS 256   // the streaming design (i8att_kernel_stream)
#define STREAM_WARPS (STREAM_THREADS / 32)

enum DType { DT_F32 = 0, DT_BF16 = 1 };

struct Args {
  const void* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  void* out;
  const int* pos;       // the position in device memory, or null
  int B, H, dk, K, n;   // n = position + 1 positions attended; with pos,
                        // the host's upper bound n_max (the layout's)
  int npg, pgp, dg;     // position groups, groups a pass (a power of 2),
                        // row groups (at most MAX_THREADS / pgp)
  int rows, sw;         // rows a row group; bytes a scale copy (16 or 4)
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

// the block's max (or sum) of v through buf, a buffer no thread has
// touched in this launch (so one barrier does), the warps in order; every
// thread gets it
__device__ __forceinline__ float block_reduce_once(float v, float* buf,
                                                   bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float r = buf[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = is_max ? fmaxf(r, buf[w]) : r + buf[w];
  return r;
}

// a float as an int that orders as the floats do (an involution), for
// atomicMax on shared memory: a max is exact in any order
__device__ __forceinline__ int ordered(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

// the positions a pair attends: a.n, or with a position in device memory
// *a.pos + 1, which must lie in 1..a.n (a.n = n_max, the bound the host
// sized the launch for); 0 when it does not, and then the pair's outputs
// are NaN (bad_position), so a fault never reads as a plausible result
__device__ __forceinline__ int attended(const Args& a) {
  if (!a.pos) return a.n;
  const int p = *a.pos;
  return p >= 0 && p < a.n ? p + 1 : 0;
}

template <typename T>
__device__ __forceinline__ void bad_position(const Args& a, size_t bh) {
  T* out = static_cast<T*>(a.out) + bh * a.dk;
  for (int d = threadIdx.x; d < a.dk; d += blockDim.x) store(out + d, NAN);
}

// The sums over a warp's 32 lanes of MR values a lane (MR a power of 2, at
// most 32), scattered: after log2(MR) halvings, at each of which a lane
// keeps half of its values and adds its partner's half, lane l holds the
// sum of value row(l) = its bits 4, 3, ... read from the top; integer sums,
// exact in any order. Returns that sum.
template <int MR>
__device__ __forceinline__ int warp_reduce_scatter(int* v, int lane) {
  int n = MR, o = 16;
#pragma unroll
  for (int level = 0; (MR >> level) > 1; ++level, o >>= 1) {
    n >>= 1;
    const bool up = lane & o;
#pragma unroll
    for (int r = 0; r < (MR >> (level + 1)); ++r) {
      const int send = up ? v[r] : v[r + n];
      const int keep = up ? v[r + n] : v[r];
      v[r] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

// the value row a lane holds after warp_reduce_scatter<MR>
template <int MR>
__device__ __forceinline__ int scatter_row(int lane) {
  int row = 0;
#pragma unroll
  for (int level = 0; (MR >> level) > 1; ++level)
    row = 2 * row + ((lane >> (4 - level)) & 1);
  return row;
}

// the n scales of a (row, head) pair into shared memory, w bytes a copy
__device__ __forceinline__ void copy_scales(float* dst, const float* src,
                                            int n, int w) {
  const int per = w / 4;
  for (int i = threadIdx.x; i < (n + per - 1) / per; i += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + per * i);
    if (w == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + per * i));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + per * i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4 words of 4 rows (4 positions each) -> 4 words of 4 rows' bytes, one
// word a position: t[j] byte i = w[i] byte j
__device__ __forceinline__ void transpose4(const int w[4], int t[4]) {
  const int x0 = __byte_perm(w[0], w[1], 0x5140);
  const int x1 = __byte_perm(w[0], w[1], 0x7362);
  const int y0 = __byte_perm(w[2], w[3], 0x5140);
  const int y1 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// 16 positions of a row, LW bytes a load; positions at or past K (only
// where K % 16 != 0) are zero
template <int LW>
__device__ __forceinline__ int4 load16(const int8_t* row, int pos, int K) {
  if (LW == 16) return __ldg(reinterpret_cast<const int4*>(row + pos));
  int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pos + 4 * i;
    if (LW == 8 && i % 2) continue;
    if (LW == 8) {
      const int2 v = p < K ? __ldg(reinterpret_cast<const int2*>(row + p))
                           : make_int2(0, 0);
      w[i] = v.x;
      w[i + 1] = v.y;
    } else {
      w[i] = p < K ? __ldg(reinterpret_cast<const int*>(row + p)) : 0;
    }
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// MR: rows a thread holds (4, 8 or 16, at least the group's)
template <typename T, int LW, int MR>
__global__ void __launch_bounds__(MAX_THREADS) i8att_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qpk[MAX_DK / 4];   // int8 q, 4 rows a word (zero past dk)
  __shared__ float red[2][MAX_WARPS];   // q's max, the exp sum
  __shared__ int smax[2];           // the score max, max |p vs| (ordered)
  const int h = blockIdx.x, b = blockIdx.y, dk = a.dk, K = a.K;
  const int n = attended(a);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t bh = (size_t)b * a.H + h;
  if (n == 0) return bad_position<T>(a, bh);
  if (tid == 0) {
    smax[0] = ordered(__float_as_int(-INFINITY));
    smax[1] = 0;
  }
  const int warp = tid >> 5;
  const int npg = a.npg, pgp = a.pgp, dg = a.dg, rows = a.rows;
  const int np = npg * PG_POS;                   // positions rounded up
  const int pg = tid % pgp, grp = tid / pgp;     // position and row group
  const int d0 = grp * rows;                     // the group's first row
  const bool active = grp < dg;
  float* sc = reinterpret_cast<float*>(smem);    // np scores, then p vs
  float* ks = sc + np;                           // the scales, np each
  float* vs = ks + np;
  int* pcw = reinterpret_cast<int*>(vs + np);    // np / 4 code words
  int* vpart = pcw + np / 4;                     // 2 x MAX_DK value sums
  int* part = vpart + 2 * MAX_DK;                // dg x pgp x 16 partials
  const int8_t* kq = a.kq + bh * dk * (size_t)K;
  const int8_t* vq = a.vq + bh * dk * (size_t)K;

  // 16 positions from p0 of the group's rows of m, zero past dk or np
  int4 v[MR];
  auto load_rows = [&](const int8_t* m, int p0) {
    const int lim = active && p0 < np ? min(rows, dk - d0) : 0;
    const int8_t* base = m + (size_t)d0 * K + p0;
#pragma unroll
    for (int i = 0; i < MR; ++i)
      v[i] = i < lim ? load16<LW>(base + (size_t)i * K, 0, K - p0)
                     : make_int4(0, 0, 0, 0);
  };

  // 1. q to int8, its load first, then the first
  // pass's K vectors and the scales, all in flight together
  const T* q = static_cast<const T*>(a.q) + bh * dk;
  float qv[MAX_DK / 32];            // rows tid, tid + nt, ... (nt >= 32)
#pragma unroll
  for (int i = 0; i < MAX_DK / 32; ++i)
    qv[i] = tid + i * nt < dk ? to_f(q[tid + i * nt]) : 0.f;
  load_rows(kq, PG_POS * pg);
  copy_scales(ks, a.ks + bh * K, n, a.sw);
  copy_scales(vs, a.vs + bh * K, n, a.sw);
  float qm = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_DK / 32; ++i) qm = fmaxf(qm, fabsf(qv[i]));
  const float qs =
      fmaxf(block_reduce_once(qm, red[0], true), 1e-12f) / 127.f;
#pragma unroll
  for (int i = 0; i < MAX_DK / 32; ++i)
    if (tid + i * nt < MAX_DK)
      reinterpret_cast<int8_t*>(qpk)[tid + i * nt] =
          (int8_t)(tid + i * nt < dk ? quant(qv[i], qs) : 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2-4. integer scores, pass by pass (MAX_PG position groups each): the
  // row groups' partials added in shared memory
  float lmax = -INFINITY;
  for (int g0 = 0; g0 < npg; g0 += pgp) {
    if (g0 > 0) load_rows(kq, PG_POS * (g0 + pg));
    int acc[PG_POS];
#pragma unroll
    for (int i = 0; i < PG_POS; ++i) acc[i] = 0;
#pragma unroll
    for (int quad = 0; quad < MR / 4; ++quad) {
      if (4 * quad >= rows) break;
      int qw = 0;                   // q of the quad's rows (zero past them)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + 4 * quad + j;
        if (4 * quad + j < rows && d < dk)
          qw |= (int)((unsigned)reinterpret_cast<const uint8_t*>(qpk)[d]
                      << (8 * j));
      }
      const int4* r = v + 4 * quad;
      const int w[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                           {r[0].y, r[1].y, r[2].y, r[3].y},
                           {r[0].z, r[1].z, r[2].z, r[3].z},
                           {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
      for (int c = 0; c < 4; ++c) {     // positions 4c .. 4c + 3
        int t[4];
        transpose4(w[c], t);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[4 * c + j] = __dp4a(t[j], qw, acc[4 * c + j]);
      }
    }
    // one pass: the V vectors now, in flight during the partial sums and
    // the softmax (the K registers are free)
    if (npg <= pgp) load_rows(vq, PG_POS * pg);
    if (active) {
      int4* dst = reinterpret_cast<int4*>(part + (grp * pgp + pg) * PG_POS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                           acc[4 * i + 3]);
    }
    __syncthreads();
    for (int i = tid; i < pgp * PG_POS; i += nt) {
      const int p = PG_POS * g0 + i;
      if (p >= n) continue;
      int si = part[i];
      for (int j = 1; j < dg; ++j) si += part[j * pgp * PG_POS + i];
      const float s = (float)si * qs * ks[p];
      sc[p] = s;
      lmax = fmaxf(lmax, s);
    }
    const float wm = warp_max(lmax);
    if (lane == 0) atomicMax(&smax[0], ordered(__float_as_int(wm)));
    __syncthreads();
  }

  // several passes: the first pass's V vectors, in flight during the
  // softmax
  if (npg > pgp) load_rows(vq, PG_POS * pg);

  // 5-7. softmax, requantized
  const float m = __int_as_float(ordered(smax[0]));
  float ls = 0.f;
  for (int p = tid; p < n; p += nt) {
    const float e = expf(sc[p] - m);
    sc[p] = e;
    ls += e;
  }
  const float sum = block_reduce_once(ls, red[1], false);
  float pm = 0.f;
  for (int p = tid; p < n; p += nt) {
    const float pv = sc[p] / sum * vs[p];
    sc[p] = pv;
    pm = fmaxf(pm, fabsf(pv));
  }
  const float wpm = warp_max(pm);
  if (lane == 0) atomicMax(&smax[1], __float_as_int(wpm));
  __syncthreads();
  const float ps = fmaxf(__int_as_float(smax[1]), 1e-20f) / 127.f;
  for (int w = tid; w < np / 4; w += nt) {
    unsigned packed = 0;
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * w + j;
      const int code = p < n ? quant(sc[p], ps) : 0;
      packed |= (unsigned)(code & 0xff) << (8 * j);
    }
    pcw[w] = (int)packed;
  }
  __syncthreads();

  // 8. value sums: a row takes 4 __dp4a over the group's 16 positions; the
  // position groups added by a shuffle tree over the lanes that share the
  // row group (pgp of them, at most 32), then over its warps
  int vacc[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) vacc[i] = 0;
  for (int g0 = 0; g0 < npg; g0 += pgp) {
    const int p0 = PG_POS * (g0 + pg);
    if (g0 > 0) load_rows(vq, p0);
    if (p0 < np) {
      const int4 c = *reinterpret_cast<const int4*>(pcw + p0 / 4);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        int x = __dp4a(v[i].x, c.x, vacc[i]);
        x = __dp4a(v[i].y, c.y, x);
        x = __dp4a(v[i].z, c.z, x);
        vacc[i] = __dp4a(v[i].w, c.w, x);
      }
    }
  }
  if (pgp >= 32) {                  // a warp's lanes share the row group
    const int sum_ = warp_reduce_scatter<MR>(vacc, lane);
    const int row = scatter_row<MR>(lane);
    if (active && lane % (32 / MR) == 0 && row < rows && d0 + row < dk)
      vpart[(pgp > 32 ? warp % 2 : 0) * MAX_DK + d0 + row] = sum_;
  } else {                          // pgp lanes a row group
#pragma unroll
    for (int i = 0; i < MR; ++i)
      for (int o = 1; o < pgp; o <<= 1)
        vacc[i] += __shfl_xor_sync(0xffffffffu, vacc[i], o);
    if (active && lane % pgp == 0)
#pragma unroll
      for (int i = 0; i < MR; ++i)
        if (i < rows && d0 + i < dk) vpart[d0 + i] = vacc[i];
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + bh * dk;
  for (int d = tid; d < dk; d += nt)
    store(out + d, (float)(pgp > 32 ? vpart[d] + vpart[MAX_DK + d]
                                    : vpart[d]) * ps);
}

// The streaming design's block reduction: the block's max (or sum) of v,
// the warps in order; every thread gets it
__device__ float stream_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();                  // red is free (an earlier reduce read it)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < STREAM_WARPS; ++w)
    r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The streaming design (the kernel's first, kept where it streams better:
// stream_wins): one block of 256 threads a pair, a thread 4 positions over
// all dk rows of K with one 4-byte load a row, the scores and then p vs in
// shared memory, the value sums a warp a row with __dp4a over 4 positions
// a lane. Its blocks hold little, so at B = 64 all 384 pairs are resident
// at once.
template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
    i8att_kernel_stream(Args a) {
  extern __shared__ float sc[];     // n4 floats: scores, then pv
  __shared__ float qf[MAX_DK];
  __shared__ int qi[MAX_DK];
  __shared__ float red[STREAM_WARPS];
  const int h = blockIdx.x, b = blockIdx.y;
  const int dk = a.dk, K = a.K, n = attended(a), n4 = (n + 3) & ~3;
  const size_t bh = (size_t)b * a.H + h;
  if (n == 0) return bad_position<T>(a, bh);
  int* pq = reinterpret_cast<int*>(sc + n4);   // n4 / 4 packed codes

  // 1. q per (row, head) to int8
  const T* q = static_cast<const T*>(a.q) + bh * dk;
  float m = 0.f;
  for (int d = threadIdx.x; d < dk; d += STREAM_THREADS) {
    qf[d] = to_f(q[d]);
    m = fmaxf(m, fabsf(qf[d]));
  }
  const float qs =
      fmaxf(stream_reduce(m, red, true), 1e-12f) / 127.f;
  for (int d = threadIdx.x; d < dk; d += STREAM_THREADS)
    qi[d] = quant(qf[d], qs);
  __syncthreads();

  // 2-4. integer scores of positions < n, rescaled
  const int8_t* kq = a.kq + bh * dk * (size_t)K;
  const float* ks = a.ks + bh * K;
  float mx = -INFINITY;
  for (int p = 4 * threadIdx.x; p < n; p += 4 * STREAM_THREADS) {
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
  mx = stream_reduce(mx, red, true);

  // 5. softmax over positions < n
  float sum = 0.f;
  for (int p = 4 * threadIdx.x; p < n; p += 4 * STREAM_THREADS)
    for (int j = 0; j < 4 && p + j < n; ++j) {
      const float e = expf(sc[p + j] - mx);
      sc[p + j] = e;
      sum += e;
    }
  sum = stream_reduce(sum, red, false);

  // 6-7. fold in the V scales, requantize
  const float* vs = a.vs + bh * K;
  float pm = 0.f;
  for (int p = 4 * threadIdx.x; p < n; p += 4 * STREAM_THREADS)
    for (int j = 0; j < 4 && p + j < n; ++j) {
      const float pv = sc[p + j] / sum * vs[p + j];
      sc[p + j] = pv;
      pm = fmaxf(pm, fabsf(pv));
    }
  const float ps =
      fmaxf(stream_reduce(pm, red, true), 1e-20f) / 127.f;
  for (int p = 4 * threadIdx.x; p < n4; p += 4 * STREAM_THREADS) {
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
  for (int d = warp; d < dk; d += STREAM_WARPS) {
    const int* row = reinterpret_cast<const int*>(vq + (size_t)d * K);
    int acc = 0;
    for (int g = lane; g < n4 / 4; g += 32) acc = __dp4a(pq[g], row[g], acc);
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) store(out + d, (float)acc * ps);
  }
}

// ---- launch -------------------------------------------------------------

// The thread layout: the position groups of a pass are the position
// groups rounded up to a power of 2, at most MAX_PG; the row groups as
// many as leave a group 4 rows, at most MAX_THREADS / pgp (so at most
// MAX_ROWS rows each: 8 at 1024 positions and d_kv 64); the block one
// thread a (position group, row group).
static void layout(Args& a) {
  a.npg = (a.n + PG_POS - 1) / PG_POS;
  int pgp = 1;
  while (pgp < a.npg && pgp < MAX_PG) pgp *= 2;
  a.pgp = pgp;
  a.dg = (a.dk + 3) / 4;
  if (a.dg > MAX_THREADS / pgp) a.dg = MAX_THREADS / pgp;
  a.rows = (a.dk + a.dg - 1) / a.dg;
}

static int threads(const Args& a) {
  return (a.pgp * a.dg + 31) / 32 * 32;
}

static size_t smem_bytes(const Args& a) {
  const size_t np = (size_t)a.npg * PG_POS;
  return 3 * np * sizeof(float) + np + 2 * MAX_DK * sizeof(int) +
         (size_t)a.dg * a.pgp * PG_POS * sizeof(int);
}

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
// (per device), so a graph captured after a launch of the same shape sets
// nothing
template <typename Kernel>
static cudaError_t grant_smem(Kernel* kernel, size_t smem, size_t fixed,
                              size_t* granted) {
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  if (smem + fixed > (size_t)info.optin) return cudaErrorInvalidValue;
  if (smem <= granted[info.dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) granted[info.dev] = smem;
  return err;
}

template <typename T, int LW, int MR>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t granted[MAX_DEVICES];
  const size_t smem = smem_bytes(a);
  cudaError_t err = grant_smem(i8att_kernel<T, LW, MR>, smem,
                               4 * (MAX_DK / 4 + MAX_WARPS), granted);
  if (err != cudaSuccess) return err;
  i8att_kernel<T, LW, MR><<<dim3(a.H, a.B), threads(a), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int LW>
static cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  if (a.rows <= 4) return launch<T, LW, 4>(a, stream);
  if (a.rows <= 8) return launch<T, LW, 8>(a, stream);
  return launch<T, LW, MAX_ROWS>(a, stream);
}

template <typename T>
static cudaError_t launch_width(const Args& a, cudaStream_t stream) {
  const uintptr_t bits = (uintptr_t)a.kq | (uintptr_t)a.vq;
  if (a.K % 16 == 0 && bits % 16 == 0) return launch_rows<T, 16>(a, stream);
  if (a.K % 8 == 0 && bits % 8 == 0) return launch_rows<T, 8>(a, stream);
  return launch_rows<T, 4>(a, stream);
}

// The design rule: the streaming design where every SM has a pair (B H >=
// #SMs) and a pair reads more than 40 KB (n (2 dk + 8) bytes), where the
// one-block design's blocks, holding a whole pass in registers, leave too
// few of them resident (B = 64: 384 pairs over 1024 positions, or 320 at
// d_kv 64); the one-block design elsewhere (PERF.md: versus).
static bool stream_wins(const Args& a, int sms) {
  return (long long)a.B * a.H >= sms &&
         (long long)a.n * (2 * a.dk + 8) > 40 * 1024;
}

template <typename T>
static cudaError_t launch_stream(const Args& a, cudaStream_t stream) {
  static size_t granted[MAX_DEVICES];
  const size_t n4 = (size_t)((a.n + 3) & ~3);
  const size_t smem = 4 * n4 + n4;  // f32 scores + packed int8 codes
  cudaError_t err = grant_smem(i8att_kernel_stream<T>, smem,
                               4 * (2 * MAX_DK + STREAM_WARPS), granted);
  if (err != cudaSuccess) return err;
  i8att_kernel_stream<T><<<dim3(a.H, a.B), STREAM_THREADS, smem, stream>>>(
      a);
  return cudaGetLastError();
}

// Both entries: the layout, the shared memory and the design from a.n
static int launch_pairs(const void* q, const void* kq, const void* ks,
                        const void* vq, const void* vs, void* out, int B,
                        int H, int dk, int K, const int* pos, int n,
                        int dtype, void* stream) {
  if (B < 1 || H < 1 || dk < 1 || dk > MAX_DK || K < 4 || K % 4 ||
      n < 1 || n > K || B > 65535 ||
      (dtype != DT_F32 && dtype != DT_BF16) ||
      ((uintptr_t)kq | (uintptr_t)vq | (uintptr_t)ks | (uintptr_t)vs |
       (uintptr_t)pos) % 4)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.kq = (const int8_t*)kq; a.ks = (const float*)ks;
  a.vq = (const int8_t*)vq; a.vs = (const float*)vs; a.out = out;
  a.pos = pos;
  a.B = B; a.H = H; a.dk = dk; a.K = K; a.n = n;
  layout(a);
  a.sw = ((uintptr_t)ks | (uintptr_t)vs) % 16 ? 4 : 16;
  DeviceInfo info;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (stream_wins(a, info.sms))
    return (int)(dtype == DT_F32 ? launch_stream<float>(a, st)
                                 : launch_stream<__nv_bfloat16>(a, st));
  return (int)(dtype == DT_F32 ? launch_width<float>(a, st)
                               : launch_width<__nv_bfloat16>(a, st));
}

extern "C" {

int i8att_max_dk() { return MAX_DK; }

// out (B, H * dk) = attention of q (B, H, dk) over positions 0..position
// of kq, vq (B, H, dk, K) int8 with scales ks, vs (B, H, 1, K) f32; q and
// out of `dtype` (DType). Returns cudaGetLastError() after the launch (0
// when it was accepted), or cudaErrorInvalidValue for arguments the
// kernel does not take, a cache span past the shared memory a block can
// opt into among them. The wrapper has checked shapes, types, contiguity
// and 4-byte alignment.
int i8att_launch(const void* q, const void* kq, const void* ks,
                 const void* vq, const void* vs, void* out, int B, int H,
                 int dk, int K, int position, int dtype, void* stream) {
  if (position < 0 || position >= K) return (int)cudaErrorInvalidValue;
  return launch_pairs(q, kq, ks, vq, vs, out, B, H, dk, K, nullptr,
                      position + 1, dtype, stream);
}

// The same with the position an int32 in device memory (pos), read by the
// kernel, so that one launch captured into a CUDA graph serves every
// position below n_max: the launch (its layout, shared memory and design)
// is sized for n_max positions, and the kernel attends over *pos + 1 of
// them. A position outside 0..n_max - 1 makes the outputs NaN.
int i8att_launch_dev(const void* q, const void* kq, const void* ks,
                     const void* vq, const void* vs, void* out, int B,
                     int H, int dk, int K, const void* pos, int n_max,
                     int dtype, void* stream) {
  if (!pos) return (int)cudaErrorInvalidValue;
  return launch_pairs(q, kq, ks, vq, vs, out, B, H, dk, K,
                      (const int*)pos, n_max, dtype, stream);
}

const char* i8att_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
