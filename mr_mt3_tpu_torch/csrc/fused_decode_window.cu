// Whole-decoder greedy-decode window for NVIDIA Hopper (sm_90a), bf16 mode.
//
// Replaces the TPU kernel mr_mt3_tpu/ops/fused_decode.py::fused_decode_window
// (pallas_call at :969, body _make_window_kernel :726, shared layer math
// _layer_ops :424 and _math_helpers :262) in its exact mode
// (quantize='fused_bf16'): bf16 weights, bf16 self/cross K/V, f32
// accumulation. One launch decodes T greedy steps: per step the embedding row
// plus the f32 position row, then per layer RMSNorm, the fused q|k|v
// projection, self-attention over the cache rows < pos0 and this window's own
// rows, the o-projection, cross-attention over the encoder K/V, the gated-GELU
// feed-forward, and after the last layer the final norm, lm_head and argmax
// (lowest index on ties). Finished rows emit pad_id; EOS finishes a row. A
// row whose logits hold a NaN emits the token V (one past the vocabulary),
// as the TPU kernel does (its max is NaN, so no index equals it); that
// token embeds as zeros, and the wrapper raises on it.
//
// Cast points are the TPU kernel's:
//   * the residual stream x is f32; _rms = w * (x * rsqrt(mean(x^2) + eps))
//     in f32, rounded to bf16 as the projection input;
//   * projections multiply bf16 activations by bf16 weights, sum in f32;
//   * cache rows of earlier windows are scored with a bf16-rounded q, and
//     their probabilities are rounded to bf16 for the value sum (one chunk,
//     so the softmax max is taken over all cache rows < pos0);
//   * rows of the current window are scored with the f32 q against the
//     bf16-stored k and summed with f32 probabilities against the bf16 v, as
//     an online softmax in window order;
//   * the self-attention output acc / l is rounded to bf16 before wo;
//   * cross-attention takes a full f32 softmax; p is rounded to bf16;
//   * gelu_new(g0) * g1 is f32, rounded to bf16 before wff_out; logits f32.
//
// Bound on the H100 (3.35 TB/s HBM, 50 MB L2), MT3 at full width, B = 8,
// Lenc = 256: a token step reads the bf16 decoder weights (8 x 2,752,512 x
// 2 B = 44.0 MB), lm_head (1.6 MB), the cross K/V (25.2 MB) and, at a mean
// cache position of 512, the self K/V (50.3 MB): ~121 MB, ~36 us per step
// or ~1.16 ms per 32-step window if every step re-read them from HBM. The
// weights alone (45.6 MB) fit in L2, so within a window the weight term is
// an L2-bandwidth term after the first step, and the least time for the
// window as a function (each input read once from HBM) is far lower:
// chip_smoke.py computes that bound from each run's shapes.
//
// Design (right and simple first): one cooperative persistent launch, one
// block of 256 threads per SM, grid-wide barriers between phases (8 per
// layer plus lm_head and argmax: 66 per step). A matrix-vector phase splits
// its output into 32-column x 8-row tiles over the blocks; each warp reads
// contiguous bf16 weight rows with 16-byte loads and sums in f32 registers,
// and the block reduces its warps in shared memory in a fixed order (the
// sums are deterministic). Attention phases give one (row, head) pair to a
// block: scores and probabilities in shared memory, one warp per value
// component, and warp 0 runs the window's online softmax. Buffers written
// inside the launch are read with ld.global.cg so no stale L1 line survives
// a barrier. The design does not approach the bound: each of the 66 phases
// of a step is a few dependent L2 round trips plus a grid barrier, so the
// step is latency-bound (an H100 80GB HBM3 at 700 W runs a 32-step window
// at B = 8 in about 22 ms at pos0 = 0 and 29 ms at pos0 = 992, PERF.md).
// Fewer phases, more blocks per phase and tensor-core products are the
// next steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define ROWS 8         // batch rows per matrix-vector tile
#define TILE_N 32      // output columns per matrix-vector tile
#define MAX_DK 128     // d_kv limit (4 components per lane in warp loops)

static_assert(ROWS == NWARPS, "load_inputs gives one warp to each row");
static_assert(NTHREADS == ROWS * TILE_N, "one thread per tile output");

struct Args {
  int B, L, H, dk, D, I, F, V, Lenc, P, T, pos0, pad_id, eos_id;
  float eps;
  // read-only inputs
  const uint16_t* embed;     // (V, D) bf16
  const float* pos_rows;     // (T, D) f32
  const uint16_t* wqkv;      // (L, D, 3I) bf16
  const uint16_t* wo;        // (L, I, D)
  const uint16_t* wqc;       // (L, D, I)
  const uint16_t* woc;       // (L, I, D)
  const uint16_t* wff_in;    // (L, D, 2F)
  const uint16_t* wff_out;   // (L, F, D)
  const float* norms;        // (L, 3, D) f32
  const float* final_norm;   // (D) f32
  const uint16_t* lm;        // (D, V) bf16
  const uint16_t* ck;        // (L, H, B, dk, Lenc) bf16
  const uint16_t* cv;
  const uint16_t* kc;        // (L, H, B, dk, P) bf16 self cache
  const uint16_t* vc;
  const int* tokens_in;      // (B)
  const int* finished_in;    // (B)
  // outputs
  int* tokens_out;           // (T, B)
  int* finished_out;         // (B)
  uint16_t* kw;              // (T, L, H*B, dk) bf16, row h*B + b
  uint16_t* vw;
  // scratch written inside the launch
  float* x;                  // (B, D) residual stream
  float* q;                  // (B, I) self / cross query
  uint16_t* attn;            // (B, I) bf16 attention output
  float* g;                  // (B, 2F) feed-forward gates
  float* logits;             // (B, V)
  int* tok;                  // (B)
  int* fin;                  // (B)
};

__device__ __forceinline__ float bf2f(uint16_t u) {
  return __uint_as_float(((uint32_t)u) << 16);
}

// round to nearest even, as torch / XLA convert f32 -> bf16
__device__ __forceinline__ uint16_t f2bf(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

__device__ __forceinline__ float bfr(float f) { return bf2f(f2bf(f)); }

__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ int ldi(const int* p) { return __ldcg(p); }
__device__ __forceinline__ float ldb(const uint16_t* p) {
  return bf2f(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reductions; red holds NWARPS floats; every thread gets the result
__device__ float block_sum(float v, float* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_sum(lane < NWARPS ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_max(lane < NWARPS ? red[lane] : -INFINITY);
}

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

enum InMode { IN_RMS, IN_BF16, IN_GATED };
enum OutMode { OUT_QKV, OUT_RESID, OUT_STORE };

// Fill hs (ROWS, K) with the bf16-rounded inputs of batch rows b0..b0+7.
__device__ void load_inputs(const Args& a, float* hs, int K, int b0,
                            InMode mode, const float* norm_w,
                            const uint16_t* in_bf16) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gb = b0 + warp;            // one warp per row (ROWS == NWARPS)
  float* row = hs + warp * K;
  if (gb >= a.B) {
    for (int k = lane; k < K; k += 32) row[k] = 0.f;
    return;
  }
  if (mode == IN_RMS) {                // K == D
    const float* xr = a.x + (size_t)gb * a.D;
    float ss = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = ldf(xr + k);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    const float rs = rsqrtf(ss / (float)K + a.eps);
    for (int k = lane; k < K; k += 32)
      row[k] = bfr(norm_w[k] * (ldf(xr + k) * rs));
  } else if (mode == IN_BF16) {        // K == I
    for (int k = lane; k < K; k += 32)
      row[k] = ldb(in_bf16 + (size_t)gb * K + k);
  } else {                             // IN_GATED, K == F
    const float* gr = a.g + (size_t)gb * 2 * a.F;
    for (int k = lane; k < K; k += 32)
      row[k] = bfr(gelu_new(ldf(gr + k)) * ldf(gr + a.F + k));
  }
}

// out[b, n] = sum_k in[b, k] * W[k, n] over (ROWS x TILE_N) tiles.
__device__ void matvec_phase(const Args& a, float* smem, int K, int N,
                             const uint16_t* W, InMode in_mode,
                             const float* norm_w, const uint16_t* in_bf16,
                             OutMode out_mode, float* out, int t, int l) {
  float* hs = smem;                        // ROWS * K
  float* red = smem + ROWS * K;            // NWARPS * ROWS * TILE_N
  const int ntile = (N + TILE_N - 1) / TILE_N;
  const int nitem = ntile * ((a.B + ROWS - 1) / ROWS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3, r = lane >> 2;   // 8-column group, row offset
  int loaded = -1;
  for (int item = blockIdx.x; item < nitem; item += gridDim.x) {
    const int grp = item / ntile, n0 = (item % ntile) * TILE_N;
    const int b0 = grp * ROWS;
    if (grp != loaded) {
      __syncthreads();
      load_inputs(a, hs, K, b0, in_mode, norm_w, in_bf16);
      __syncthreads();
      loaded = grp;
    }
    float acc[ROWS][8];
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[b][j] = 0.f;
    const int ncol = n0 + c * 8;
    if (ncol < N) {
      for (int k = warp * 8 + r; k < K; k += NWARPS * 8) {
        const uint4 wv =
            *reinterpret_cast<const uint4*>(W + (size_t)k * N + ncol);
        const uint32_t u[4] = {wv.x, wv.y, wv.z, wv.w};
        float w[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[2 * j] = __uint_as_float(u[j] << 16);
          w[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
        }
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          const float h = hs[b * K + k];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[b][j] = fmaf(h, w[j], acc[b][j]);
        }
      }
    }
    // sum the 8 row offsets of the warp (lane bits 2..4), fixed order
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[b][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[b][j] = v;
      }
    if (r == 0) {
#pragma unroll
      for (int b = 0; b < ROWS; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[(warp * ROWS + b) * TILE_N + c * 8 + j] = acc[b][j];
    }
    __syncthreads();
    {
      const int b = threadIdx.x / TILE_N, col = threadIdx.x % TILE_N;
      float v = 0.f;
      for (int w2 = 0; w2 < NWARPS; ++w2)
        v += red[(w2 * ROWS + b) * TILE_N + col];
      const int gb = b0 + b, n = n0 + col;
      if (gb < a.B && n < N) {
        if (out_mode == OUT_QKV) {
          if (n < a.I) {
            __stcg(a.q + (size_t)gb * a.I + n, v);
          } else {
            const int nn = (n - a.I) % a.I;
            uint16_t* dst = (n < 2 * a.I) ? a.kw : a.vw;
            const int hb = (nn / a.dk) * a.B + gb;
            const size_t off =
                (((size_t)t * a.L + l) * a.H * a.B + hb) * a.dk + nn % a.dk;
            dst[off] = f2bf(v);
          }
        } else if (out_mode == OUT_RESID) {
          float* px = a.x + (size_t)gb * a.D + n;
          __stcg(px, ldf(px) + v);
        } else {
          __stcg(out + (size_t)gb * N + n, v);
        }
      }
    }
    __syncthreads();
  }
}

// Self-attention for one layer: cache rows < pos0, then window rows 0..t.
__device__ void self_attn_phase(const Args& a, float* smem, int t, int l) {
  float* qs = smem;                 // MAX_DK f32 q
  float* qb = qs + MAX_DK;          // MAX_DK bf16-rounded q
  float* accs = qb + MAX_DK;        // MAX_DK cache-part sums
  float* red = accs + MAX_DK;       // NWARPS
  float* sc = red + NWARPS;         // P scores, then bf16 probabilities
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dk = a.dk, P0 = a.pos0, HB = a.H * a.B;
  for (int item = blockIdx.x; item < HB; item += gridDim.x) {
    const int h = item / a.B, b = item % a.B;     // item == h * B + b
    __syncthreads();
    for (int d = threadIdx.x; d < dk; d += NTHREADS) {
      const float v = ldf(a.q + (size_t)b * a.I + h * dk + d);
      qs[d] = v;
      qb[d] = bfr(v);
    }
    __syncthreads();
    float m = -1e30f, lsum = 0.f;
    if (P0 > 0) {
      const size_t base = ((size_t)(l * a.H + h) * a.B + b) * dk * a.P;
      const uint16_t* K = a.kc + base;
      const uint16_t* Vv = a.vc + base;
      float lmax = -INFINITY;
      for (int p = threadIdx.x; p < P0; p += NTHREADS) {
        float s = 0.f;
        for (int d = 0; d < dk; ++d)
          s = fmaf(qb[d], bf2f(K[(size_t)d * a.P + p]), s);
        sc[p] = s;
        lmax = fmaxf(lmax, s);
      }
      m = block_max(lmax, red);
      float ls = 0.f;
      for (int p = threadIdx.x; p < P0; p += NTHREADS) {
        const float e = expf(sc[p] - m);
        ls += e;
        sc[p] = bfr(e);
      }
      lsum = block_sum(ls, red);
      for (int d = warp; d < dk; d += NWARPS) {
        const uint16_t* Vd = Vv + (size_t)d * a.P;
        float s = 0.f;
        for (int p = lane; p < P0; p += 32) s = fmaf(sc[p], bf2f(Vd[p]), s);
        s = warp_sum(s);
        if (lane == 0) accs[d] = s;
      }
      __syncthreads();
    }
    if (warp == 0) {
      float acc[MAX_DK / 32], qv[MAX_DK / 32];
#pragma unroll
      for (int i = 0; i < MAX_DK / 32; ++i) {
        const int d = lane + 32 * i;
        acc[i] = (P0 > 0 && d < dk) ? accs[d] : 0.f;
        qv[i] = d < dk ? qs[d] : 0.f;
      }
      const size_t jstride = (size_t)a.L * HB * dk;
      const size_t row = ((size_t)l * HB + item) * dk;
      for (int j = 0; j <= t; ++j) {
        float kj[MAX_DK / 32], vj[MAX_DK / 32];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_DK / 32; ++i) {
          const int d = lane + 32 * i;
          kj[i] = d < dk ? ldb(a.kw + j * jstride + row + d) : 0.f;
          vj[i] = d < dk ? ldb(a.vw + j * jstride + row + d) : 0.f;
          s = fmaf(qv[i], kj[i], s);
        }
        s = warp_sum(s);
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        lsum = lsum * alpha + p;
#pragma unroll
        for (int i = 0; i < MAX_DK / 32; ++i) acc[i] = acc[i] * alpha + p * vj[i];
        m = m_new;
      }
#pragma unroll
      for (int i = 0; i < MAX_DK / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < dk) a.attn[(size_t)b * a.I + h * dk + d] = f2bf(acc[i] / lsum);
      }
    }
  }
}

// Cross-attention for one layer over the encoder K/V (full f32 softmax).
__device__ void cross_attn_phase(const Args& a, float* smem, int l) {
  float* qb = smem;                 // MAX_DK bf16-rounded q
  float* red = qb + MAX_DK;         // NWARPS
  float* sc = red + NWARPS;         // Lenc scores, then bf16 probabilities
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dk = a.dk, S = a.Lenc, HB = a.H * a.B;
  for (int item = blockIdx.x; item < HB; item += gridDim.x) {
    const int h = item / a.B, b = item % a.B;
    __syncthreads();
    for (int d = threadIdx.x; d < dk; d += NTHREADS)
      qb[d] = bfr(ldf(a.q + (size_t)b * a.I + h * dk + d));
    __syncthreads();
    const size_t base = ((size_t)(l * a.H + h) * a.B + b) * dk * S;
    const uint16_t* K = a.ck + base;
    const uint16_t* Vv = a.cv + base;
    float lmax = -INFINITY;
    for (int p = threadIdx.x; p < S; p += NTHREADS) {
      float s = 0.f;
      for (int d = 0; d < dk; ++d)
        s = fmaf(qb[d], bf2f(K[(size_t)d * S + p]), s);
      sc[p] = s;
      lmax = fmaxf(lmax, s);
    }
    const float m = block_max(lmax, red);
    float ls = 0.f;
    for (int p = threadIdx.x; p < S; p += NTHREADS) {
      const float e = expf(sc[p] - m);
      ls += e;
      sc[p] = e;
    }
    const float lsum = block_sum(ls, red);
    for (int p = threadIdx.x; p < S; p += NTHREADS) sc[p] = bfr(sc[p] / lsum);
    __syncthreads();
    for (int d = warp; d < dk; d += NWARPS) {
      const uint16_t* Vd = Vv + (size_t)d * S;
      float s = 0.f;
      for (int p = lane; p < S; p += 32) s = fmaf(sc[p], bf2f(Vd[p]), s);
      s = warp_sum(s);
      if (lane == 0) a.attn[(size_t)b * a.I + h * dk + d] = f2bf(s);
    }
  }
}

// x[b] = embed[token] + pos_rows[t] for this block's rows; a token outside
// the vocabulary (the NaN token V) embeds as zeros, like a one-hot matmul.
__device__ void embed_row(const Args& a, int b, int token, int t) {
  const bool in_vocab = token >= 0 && token < a.V;
  const uint16_t* e = a.embed + (size_t)(in_vocab ? token : 0) * a.D;
  const float* pr = a.pos_rows + (size_t)t * a.D;
  for (int d = threadIdx.x; d < a.D; d += NTHREADS)
    __stcg(a.x + (size_t)b * a.D + d, (in_vocab ? bf2f(e[d]) : 0.f) + pr[d]);
}

__device__ void init_phase(const Args& a) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int token = a.tokens_in[b];
    if (threadIdx.x == 0) {
      __stcg(a.tok + b, token);
      __stcg(a.fin + b, a.finished_in[b] != 0 ? 1 : 0);
    }
    embed_row(a, b, token, 0);
  }
}

// Argmax (lowest index on ties; V if a logit is NaN), finished
// bookkeeping, next step's embed.
__device__ void argmax_phase(const Args& a, float* smem, int t) {
  float* bestv = smem;
  int* besti = reinterpret_cast<int*>(smem + NWARPS);
  int* nanw = besti + NWARPS;
  int* next = nanw + NWARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float best = -INFINITY;
    int bi = a.V;
    bool has_nan = false;
    for (int v = threadIdx.x; v < a.V; v += NTHREADS) {
      const float x = ldf(a.logits + (size_t)b * a.V + v);
      has_nan |= x != x;
      if (x > best || (x == best && v < bi)) { best = x; bi = v; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    has_nan = __any_sync(0xffffffffu, has_nan);
    __syncthreads();
    if (lane == 0) {
      bestv[warp] = best;
      besti[warp] = bi;
      nanw[warp] = has_nan;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < NWARPS; ++w)
        if (bestv[w] > best || (bestv[w] == best && besti[w] < bi)) {
          best = bestv[w];
          bi = besti[w];
        }
      for (int w = 0; w < NWARPS; ++w)
        if (nanw[w]) bi = a.V;
      int f = ldi(a.fin + b);
      const int nxt = f ? a.pad_id : bi;
      if (nxt == a.eos_id) f = 1;
      __stcg(a.fin + b, f);
      __stcg(a.tok + b, nxt);
      a.tokens_out[(size_t)t * a.B + b] = nxt;
      if (t == a.T - 1) a.finished_out[b] = f;
      *next = nxt;
    }
    __syncthreads();
    if (t + 1 < a.T) embed_row(a, b, *next, t + 1);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) fdw_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int I = a.I, D = a.D, F = a.F;
  init_phase(a);
  grid.sync();
  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < a.L; ++l) {
      const float* nw = a.norms + (size_t)l * 3 * D;
      matvec_phase(a, smem, D, 3 * I, a.wqkv + (size_t)l * D * 3 * I,
                   IN_RMS, nw, nullptr, OUT_QKV, nullptr, t, l);
      grid.sync();
      self_attn_phase(a, smem, t, l);
      grid.sync();
      matvec_phase(a, smem, I, D, a.wo + (size_t)l * I * D, IN_BF16,
                   nullptr, a.attn, OUT_RESID, nullptr, t, l);
      grid.sync();
      matvec_phase(a, smem, D, I, a.wqc + (size_t)l * D * I, IN_RMS,
                   nw + D, nullptr, OUT_STORE, a.q, t, l);
      grid.sync();
      cross_attn_phase(a, smem, l);
      grid.sync();
      matvec_phase(a, smem, I, D, a.woc + (size_t)l * I * D, IN_BF16,
                   nullptr, a.attn, OUT_RESID, nullptr, t, l);
      grid.sync();
      matvec_phase(a, smem, D, 2 * F, a.wff_in + (size_t)l * D * 2 * F,
                   IN_RMS, nw + 2 * D, nullptr, OUT_STORE, a.g, t, l);
      grid.sync();
      matvec_phase(a, smem, F, D, a.wff_out + (size_t)l * F * D, IN_GATED,
                   nullptr, nullptr, OUT_RESID, nullptr, t, l);
      grid.sync();
    }
    matvec_phase(a, smem, D, a.V, a.lm, IN_RMS, a.final_norm, nullptr,
                 OUT_STORE, a.logits, t, 0);
    grid.sync();
    argmax_phase(a, smem, t);
    grid.sync();
  }
}

extern "C" {

// Launch one window on `stream`. Returns cudaGetLastError() after the launch
// (0 when it was accepted).
int fdw_launch(const void* embed, const void* pos_rows, const void* wqkv,
               const void* wo, const void* wqc, const void* woc,
               const void* wff_in, const void* wff_out, const void* norms,
               const void* final_norm, const void* lm, const void* ck,
               const void* cv, const void* kc, const void* vc,
               const void* tokens_in, const void* finished_in,
               void* tokens_out, void* finished_out, void* kw, void* vw,
               void* x, void* q, void* attn, void* g, void* logits,
               void* tok, void* fin, int B, int L, int H, int dk, int D,
               int F, int V, int Lenc, int P, int T, int pos0, int pad_id,
               int eos_id, float eps, void* stream) {
  Args a;
  a.B = B; a.L = L; a.H = H; a.dk = dk; a.D = D; a.I = H * dk; a.F = F;
  a.V = V; a.Lenc = Lenc; a.P = P; a.T = T; a.pos0 = pos0;
  a.pad_id = pad_id; a.eos_id = eos_id; a.eps = eps;
  a.embed = (const uint16_t*)embed; a.pos_rows = (const float*)pos_rows;
  a.wqkv = (const uint16_t*)wqkv; a.wo = (const uint16_t*)wo;
  a.wqc = (const uint16_t*)wqc; a.woc = (const uint16_t*)woc;
  a.wff_in = (const uint16_t*)wff_in; a.wff_out = (const uint16_t*)wff_out;
  a.norms = (const float*)norms; a.final_norm = (const float*)final_norm;
  a.lm = (const uint16_t*)lm; a.ck = (const uint16_t*)ck;
  a.cv = (const uint16_t*)cv; a.kc = (const uint16_t*)kc;
  a.vc = (const uint16_t*)vc; a.tokens_in = (const int*)tokens_in;
  a.finished_in = (const int*)finished_in; a.tokens_out = (int*)tokens_out;
  a.finished_out = (int*)finished_out; a.kw = (uint16_t*)kw;
  a.vw = (uint16_t*)vw; a.x = (float*)x; a.q = (float*)q;
  a.attn = (uint16_t*)attn; a.g = (float*)g; a.logits = (float*)logits;
  a.tok = (int*)tok; a.fin = (int*)fin;

  int kmax = D > a.I ? D : a.I;
  if (F > kmax) kmax = F;
  const int mv_floats = ROWS * kmax + NWARPS * ROWS * TILE_N;
  const int att_floats = 3 * MAX_DK + NWARPS + (P > Lenc ? P : Lenc);
  const int arg_floats = 3 * NWARPS + 1;
  int floats = mv_floats > att_floats ? mv_floats : att_floats;
  if (arg_floats > floats) floats = arg_floats;
  const size_t smem = (size_t)floats * sizeof(float);

  cudaError_t err = cudaFuncSetAttribute(
      fdw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fdw_kernel,
                                                      NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  dim3 grid(sms), block(NTHREADS);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)fdw_kernel, grid, block, args,
                                    smem, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

const char* fdw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
