// Whole-decoder megakernel for NVIDIA Hopper (sm_90a): the device code shared
// by csrc/fused_decode_window.cu (the greedy window and its grouped int8
// form) and csrc/fused_decode_step.cu (one decoder step with its logits).
//
// It covers the TPU kernels of mr_mt3_tpu/ops/fused_decode.py (shared layer
// math _layer_ops :424 and _math_helpers :262) in their three modes, chosen at
// compile time (template parameter MODE, one instantiation each):
//   MODE_BF16 (quantize='fused_bf16'): bf16 weights, bf16 self/cross K/V;
//   MODE_INT8 (quantize='fused'): int8 weight codes with an f32 scale per
//     output column, int8 self/cross K/V codes with an f32 scale per
//     position;
//   MODE_INT4 (quantize='fused_int4'): the same with codes in [-7, 7],
//     stored two per byte along the contiguous axis (byte i: code 2i in the
//     low nibble, code 2i+1 in the high nibble, 4-bit two's complement).
// and three kinds of launch (template parameter KIND):
//   KIND_WINDOW: T greedy steps (fused_decode_window :840). Per step the
//     embedding row plus the f32 position row, then per layer RMSNorm, the
//     fused q|k|v projection, self-attention over the cache rows < pos0 and
//     this window's own rows, the o-projection, cross-attention over the
//     encoder K/V, the gated-GELU feed-forward, and after the last layer the
//     final norm, lm_head and argmax (lowest index on ties). Finished rows
//     emit pad_id; EOS finishes a row. A row whose logits hold a NaN emits
//     the token V (one past the vocabulary), as the TPU kernel does (its max
//     is NaN, so no index equals it); that token embeds as zeros, and the
//     wrapper raises on it.
//   KIND_GROUPED: the same in the int8 mode over G groups of 8 rows in the
//     layouts of benchmarks/group_axis_kernel.py (cache and cross K/V
//     (L*G, H, 8, ...), emitted rows (T, L*G, H*8, ...)), with the emitted
//     K/V scales rounded to bf16 (:140-150).
//   KIND_STEP: one step (fused_decode_step :564) from a given f32 input row
//     x (the wrapper gathers embedding + position rows), ending at the
//     logits; the current position enters self-attention as an f32 diagonal
//     term on the unrounded q, k, v (:537-548).
//
// Cast points are the TPU kernel's:
//   * the residual stream x is f32; _rms = w * (x * rsqrt(mean(x^2) + eps))
//     in f32, rounded to bf16 as the projection input;
//   * projections multiply bf16 activations by bf16 weights (or by integer
//     codes, exact in bf16), sum in f32, and in the int modes multiply the
//     sum by the column scale;
//   * cache rows (positions < pos0) are attended as a flash update over
//     chunks of `chunk` positions (flash_chunk :453-470): per live chunk the
//     running max takes the chunk's max, and
//       bf16: scores with a bf16-rounded q; p = exp(s - m_running) rounded
//         to bf16 for the value sum;
//       int: q quantized per (row, head) to int8 (scale max|q| / 127, floor
//         1e-12), the code dot summed in int32 and multiplied by
//         qscale * ks[pos]; p * vs[pos] requantized per (row, head) and
//         chunk to int8 (scale max|p vs| / 127 over the chunk, floor
//         1e-20), the value dot summed in int32 and multiplied by that
//         scale (values_mxu :312-322).
//     The window attends all of them as one chunk, the step and the
//     grouped window in the TPU kernel's chunks;
//   * window rows of the current window are scored with the f32 q against
//     the bf16-rounded k and summed with f32 probabilities against the bf16
//     v, as an online softmax in window order (all modes: the int modes keep
//     the window's rows in bf16 for this, beside the codes they emit); the
//     step's one row is its f32 k and v;
//   * the int modes emit each step's k and v rows as codes with one f32
//     scale per (row, head): scale max|k| / qmax (floor 1e-12), codes
//     rint(k / scale) clipped to +-qmax (rint rounds half to even, as
//     jnp.round does);
//   * the self-attention output acc / l is rounded to bf16 before wo;
//   * cross-attention takes a full f32 softmax (int: over the dequantized
//     int32 code dot, then p * cvs requantized as above); the output is
//     rounded to bf16;
//   * gelu_new(g0) * g1 is f32, rounded to bf16 before wff_out; logits f32.
// Integer dot products are exact int32 sums, so they match the plain
// version bit for bit whatever the order. Built without --use_fast_math:
// expf and the divisions that make the scales are the IEEE ones.
//
// Design (right and simple first): one cooperative persistent launch, one
// block of 256 threads per SM, grid-wide barriers between phases (8 per
// layer plus lm_head, and in a window the argmax). A matrix-vector phase
// splits its output into 32-column x 8-row tiles over the blocks; each warp
// reads 8 contiguous weights of a row with one load (16 bytes in bf16, 8 in
// int8, 4 in int4), widens them to f32 in registers and sums in f32, and
// the block reduces its warps in shared memory in a fixed order (the sums
// are deterministic). Attention phases give one (row, head) pair to a
// block: scores and probabilities in shared memory, one thread per cache
// row for the score dot, one warp per value component, and warp 0 runs the
// window's online softmax. In the int modes the same block first quantizes
// its pair's k and v rows of the step. Buffers written inside the launch
// are read with ld.global.cg so no stale L1 line survives a barrier. The
// design does not approach the bound: each phase is a few dependent L2
// round trips plus a grid barrier, so a step is latency-bound (PERF.md).

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
#define GROUP_ROWS 8   // rows per group of the grouped layout

static_assert(ROWS == NWARPS, "load_inputs gives one warp to each row");
static_assert(NTHREADS == ROWS * TILE_N, "one thread per tile output");

enum Mode { MODE_BF16 = 0, MODE_INT8 = 1, MODE_INT4 = 2 };
enum Kind { KIND_WINDOW = 0, KIND_GROUPED = 1, KIND_STEP = 2 };

struct Args {
  int B, L, H, dk, D, I, F, V, Lenc, P, T, pos0, pad_id, eos_id, qmax, chunk;
  float eps;
  // read-only inputs; weights are bf16, int8 or packed int4 by mode
  const uint16_t* embed;     // (V, D) bf16 (window kinds)
  const float* pos_rows;     // (T, D) f32 (window kinds)
  const void* wqkv;          // (L, D, 3I)
  const void* wo;            // (L, I, D)
  const void* wqc;           // (L, D, I)
  const void* woc;           // (L, I, D)
  const void* wff_in;        // (L, D, 2F)
  const void* wff_out;       // (L, F, D)
  const float* sqkv;         // (L, 3I) f32 column scales (int modes)
  const float* so;           // (L, D)
  const float* sqc;          // (L, I)
  const float* soc;          // (L, D)
  const float* sff_in;       // (L, 2F)
  const float* sff_out;      // (L, D)
  const float* norms;        // (L, 3, D) f32
  const float* final_norm;   // (D) f32
  const void* lm;            // (D, V)
  const float* lm_s;         // (V) f32 (int modes)
  const void* ck;            // (L, H, B, dk, Lenc); grouped (L*G, H, 8, ...)
  const void* cv;
  const float* cks;          // (L, H, B, Lenc) f32 (int modes)
  const float* cvs;
  const void* kc;            // (L, H, B, dk, P) self cache; grouped as ck
  const void* vc;
  const float* ks;           // (L, H, B, P) f32 (int modes)
  const float* vs;
  const int* tokens_in;      // (B) (window kinds)
  const int* finished_in;    // (B)
  // outputs
  int* tokens_out;           // (T, B) (window kinds)
  int* finished_out;         // (B)
  uint16_t* kw;              // (T, L, H*B, dk) bf16 rows, h*B + b (the
  uint16_t* vw;              //   output in bf16 mode, else scratch)
  int8_t* kq_out;            // (T, L, H*B, dk) codes (int modes; grouped
  int8_t* vq_out;            //   (T, L*G, H*8, dk))
  float* ks_out;             // (T, L, H*B) f32 scales (int modes)
  float* vs_out;
  // scratch written inside the launch
  float* x;                  // (B, D) residual stream (step: the input row)
  float* q;                  // (B, I) self / cross query
  uint16_t* attn;            // (B, I) bf16 attention output
  float* g;                  // (B, 2F) feed-forward gates
  float* logits;             // (B, V) (the step's output)
  int* tok;                  // (B)
  int* fin;                  // (B)
  float* kvf;                // (B, 2I) f32 k | v of the step (int modes and
                             //   the step)
};

// The row of batch row b, head h, layer l in the cache, cross K/V and
// emitted-row arrays: (l, h, b) head-major, or in the grouped layout
// (l, group, h, row of the group).
template <int KIND>
__device__ __forceinline__ size_t pair_index(const Args& a, int l, int h,
                                             int b) {
  if (KIND == KIND_GROUPED)
    return ((size_t)(l * (a.B / GROUP_ROWS) + b / GROUP_ROWS) * a.H + h) *
               GROUP_ROWS + b % GROUP_ROWS;
  return ((size_t)l * a.H + h) * a.B + b;
}

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

// symmetric code of x at scale s: rint (half to even) clipped to +-qmax
__device__ __forceinline__ int quant(float x, float s, float qmax) {
  return (int)fminf(fmaxf(rintf(x / s), -qmax), qmax);
}

// the integer code at element index idx of an int8 or packed int4 array
template <int MODE>
__device__ __forceinline__ int code_at(const void* base, size_t idx) {
  if (MODE == MODE_INT8) return (int)static_cast<const int8_t*>(base)[idx];
  const uint8_t byte = static_cast<const uint8_t*>(base)[idx >> 1];
  return (idx & 1) ? ((int)(int8_t)byte >> 4)
                   : ((int)(int8_t)(uint8_t)(byte << 4) >> 4);
}

// 8 consecutive weights at element index elem (a multiple of 8), as f32
template <int MODE>
__device__ __forceinline__ void load_w8(const void* W, size_t elem,
                                        float w[8]) {
  if (MODE == MODE_BF16) {
    const uint4 wv = *reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(W) + elem);
    const uint32_t u[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = __uint_as_float(u[j] << 16);
      w[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  } else if (MODE == MODE_INT8) {
    const uint2 wv = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(W) + elem);
    const uint32_t u[2] = {wv.x, wv.y};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[4 * j + i] = (float)(int)(int8_t)(uint8_t)(u[j] >> (8 * i));
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(
        static_cast<const uint8_t*>(W) + elem / 2);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = (float)((int)(u << (28 - 4 * j)) >> 28);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
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

// out[b, n] = (sum_k in[b, k] * W[k, n]) * scale[n] over (ROWS x TILE_N)
// tiles; W starts at element w_off of the array; scale is skipped in bf16.
template <int MODE, int KIND>
__device__ void matvec_phase(const Args& a, float* smem, int K, int N,
                             const void* W, size_t w_off, const float* scale,
                             InMode in_mode, const float* norm_w,
                             const uint16_t* in_bf16, OutMode out_mode,
                             float* out, int t, int l) {
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
        float w[8];
        load_w8<MODE>(W, w_off + (size_t)k * N + ncol, w);
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
        if (MODE != MODE_BF16) v *= scale[n];
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
            if (MODE != MODE_BF16 || KIND == KIND_STEP)
              __stcg(a.kvf + (size_t)gb * 2 * a.I + (n - a.I), v);
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

// int modes: quantize this step's k and v rows of (head h, batch row b)
// per row into the code and scale outputs (scales rounded to bf16 in the
// grouped kind).
template <int KIND>
__device__ void emit_rows(const Args& a, float* red, int t, int l, int h,
                          int b) {
  const int dk = a.dk;
  const float* kr = a.kvf + (size_t)b * 2 * a.I + h * dk;
  const float* vr = kr + a.I;
  float km = 0.f, vm = 0.f;
  for (int d = threadIdx.x; d < dk; d += NTHREADS) {
    km = fmaxf(km, fabsf(ldf(kr + d)));
    vm = fmaxf(vm, fabsf(ldf(vr + d)));
  }
  const float qmax = (float)a.qmax;
  const float kscale = fmaxf(block_max(km, red), 1e-12f) / qmax;
  const float vscale = fmaxf(block_max(vm, red), 1e-12f) / qmax;
  const size_t row =
      (size_t)t * a.L * a.H * a.B + pair_index<KIND>(a, l, h, b);
  for (int d = threadIdx.x; d < dk; d += NTHREADS) {
    a.kq_out[row * dk + d] = (int8_t)quant(ldf(kr + d), kscale, qmax);
    a.vq_out[row * dk + d] = (int8_t)quant(ldf(vr + d), vscale, qmax);
  }
  if (threadIdx.x == 0) {
    a.ks_out[row] = KIND == KIND_GROUPED ? bfr(kscale) : kscale;
    a.vs_out[row] = KIND == KIND_GROUPED ? bfr(vscale) : vscale;
  }
}

// int modes: qi = q quantized to int8 (one scale for the (row, head));
// returns the scale. qs holds the f32 q; every thread gets the scale.
__device__ float quantize_q(const float* qs, int* qi, int dk, float* red) {
  float am = 0.f;
  for (int d = threadIdx.x; d < dk; d += NTHREADS) am = fmaxf(am, fabsf(qs[d]));
  const float qscale = fmaxf(block_max(am, red), 1e-12f) / 127.f;
  for (int d = threadIdx.x; d < dk; d += NTHREADS)
    qi[d] = quant(qs[d], qscale, 127.f);
  __syncthreads();
  return qscale;
}

// int modes: attention of one (row, head) over n positions of an integer
// K/V (row length rowlen elements) with per-position scales ksc / vsc.
// norm: probabilities e / sum(e) (cross) or e (cache). The max is taken
// over the n scores and m_prev (-INFINITY for none). out[d] (warp lanes 0)
// receives the dequantized value sums, or with accumulate, out[d] *
// exp(m_prev - max) plus them (a flash chunk). Returns (max, sum of e).
template <int MODE>
__device__ float2 int_attend(const Args& a, const int* qi, float qscale,
                             const void* K, const void* Vv, size_t base,
                             int rowlen, const float* ksc, const float* vsc,
                             int n, bool norm, float m_prev, bool accumulate,
                             float* sc, float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dk = a.dk;
  float lmax = -INFINITY;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    int s = 0;
    for (int d = 0; d < dk; ++d)
      s += qi[d] * code_at<MODE>(K, base + (size_t)d * rowlen + p);
    const float sf = ((float)s * qscale) * ksc[p];
    sc[p] = sf;
    lmax = fmaxf(lmax, sf);
  }
  const float m = fmaxf(block_max(lmax, red), m_prev);
  float ls = 0.f;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    const float e = expf(sc[p] - m);
    ls += e;
    sc[p] = e;
  }
  const float lsum = block_sum(ls, red);
  float pm = 0.f;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    const float pv = (norm ? sc[p] / lsum : sc[p]) * vsc[p];
    sc[p] = pv;
    pm = fmaxf(pm, fabsf(pv));
  }
  const float pscale = fmaxf(block_max(pm, red), 1e-20f) / 127.f;
  for (int p = threadIdx.x; p < n; p += NTHREADS)
    sc[p] = (float)quant(sc[p], pscale, 127.f);
  __syncthreads();
  const float alpha = accumulate ? expf(m_prev - m) : 0.f;
  for (int d = warp; d < dk; d += NWARPS) {
    int s = 0;
    for (int p = lane; p < n; p += 32)
      s += (int)sc[p] * code_at<MODE>(Vv, base + (size_t)d * rowlen + p);
    s = warp_sum_int(s);
    if (lane == 0) {
      const float v = (float)s * pscale;
      out[d] = accumulate ? out[d] * alpha + v : v;
    }
  }
  __syncthreads();
  return make_float2(m, lsum);
}

// bf16 mode: one flash chunk of the cache, n positions from element offset
// base of K/V rows of length rowlen, against the bf16-rounded q qb; the same
// contract as int_attend with norm false.
__device__ float2 bf16_attend(const Args& a, const float* qb,
                              const uint16_t* K, const uint16_t* Vv,
                              int rowlen, int n, float m_prev,
                              bool accumulate, float* sc, float* red,
                              float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dk = a.dk;
  float lmax = -INFINITY;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    float s = 0.f;
    for (int d = 0; d < dk; ++d)
      s = fmaf(qb[d], bf2f(K[(size_t)d * rowlen + p]), s);
    sc[p] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = fmaxf(block_max(lmax, red), m_prev);
  float ls = 0.f;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    const float e = expf(sc[p] - m);
    ls += e;
    sc[p] = bfr(e);
  }
  const float lsum = block_sum(ls, red);
  const float alpha = accumulate ? expf(m_prev - m) : 0.f;
  for (int d = warp; d < dk; d += NWARPS) {
    const uint16_t* Vd = Vv + (size_t)d * rowlen;
    float s = 0.f;
    for (int p = lane; p < n; p += 32) s = fmaf(sc[p], bf2f(Vd[p]), s);
    s = warp_sum(s);
    if (lane == 0) out[d] = accumulate ? out[d] * alpha + s : s;
  }
  __syncthreads();
  return make_float2(m, lsum);
}

// Self-attention for one layer: the cache rows < pos0 in flash chunks, then
// the window rows 0..t (the step: its own f32 row).
template <int MODE, int KIND>
__device__ void self_attn_phase(const Args& a, float* smem, int t, int l) {
  float* qs = smem;                 // MAX_DK f32 q
  float* qb = qs + MAX_DK;          // MAX_DK bf16-rounded q (int: int8 q)
  float* accs = qb + MAX_DK;        // MAX_DK cache-part sums
  float* red = accs + MAX_DK;       // NWARPS
  float* sc = red + NWARPS;         // chunk scores, then probabilities
  int* qi = reinterpret_cast<int*>(qb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dk = a.dk, P0 = a.pos0, HB = a.H * a.B;
  for (int item = blockIdx.x; item < HB; item += gridDim.x) {
    const int h = item / a.B, b = item % a.B;     // item == h * B + b
    __syncthreads();
    for (int d = threadIdx.x; d < dk; d += NTHREADS) {
      const float v = ldf(a.q + (size_t)b * a.I + h * dk + d);
      qs[d] = v;
      if (MODE == MODE_BF16) qb[d] = bfr(v);
    }
    if (MODE != MODE_BF16) emit_rows<KIND>(a, red, t, l, h, b);
    __syncthreads();
    float m = -1e30f, lsum = 0.f;
    const size_t pair = pair_index<KIND>(a, l, h, b);
    const float qscale =
        (MODE != MODE_BF16 && P0 > 0) ? quantize_q(qs, qi, dk, red) : 0.f;
    if (KIND == KIND_WINDOW && P0 > 0) {
      // The window's cache rows are one chunk, attended in one call: the
      // same call inside the chunk loop below made the int4 window ~19%
      // slower at pos0 992 (chip_smoke.py's window cases, PERF.md).
      float2 ml;
      if (MODE == MODE_BF16) {
        const size_t base = pair * dk * a.P;
        ml = bf16_attend(a, qb, static_cast<const uint16_t*>(a.kc) + base,
                         static_cast<const uint16_t*>(a.vc) + base, a.P, P0,
                         -INFINITY, false, sc, red, accs);
      } else {
        ml = int_attend<MODE>(a, qi, qscale, a.kc, a.vc, pair * dk * a.P,
                              a.P, a.ks + pair * a.P, a.vs + pair * a.P, P0,
                              false, -INFINITY, false, sc, red, accs);
      }
      m = ml.x;
      lsum = ml.y;
    }
    for (int c0 = 0; KIND != KIND_WINDOW && c0 < P0; c0 += a.chunk) {
      const int n = min(a.chunk, P0 - c0);
      const bool acc = c0 > 0;          // a later chunk updates the sums
      const float m_prev = acc ? m : -INFINITY;
      float2 ml;
      if (MODE == MODE_BF16) {
        const size_t base = pair * dk * a.P + c0;
        ml = bf16_attend(a, qb, static_cast<const uint16_t*>(a.kc) + base,
                         static_cast<const uint16_t*>(a.vc) + base, a.P, n,
                         m_prev, acc, sc, red, accs);
      } else {
        ml = int_attend<MODE>(a, qi, qscale, a.kc, a.vc, pair * dk * a.P + c0,
                              a.P, a.ks + pair * a.P + c0,
                              a.vs + pair * a.P + c0, n, false, m_prev, acc,
                              sc, red, accs);
      }
      lsum = acc ? lsum * expf(m_prev - ml.x) + ml.y : ml.y;
      m = ml.x;
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
      const float* kf = a.kvf + (size_t)b * 2 * a.I + h * dk;
      for (int j = 0; j <= t; ++j) {
        float kj[MAX_DK / 32], vj[MAX_DK / 32];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_DK / 32; ++i) {
          const int d = lane + 32 * i;
          if (KIND == KIND_STEP) {      // the diagonal term, f32
            kj[i] = d < dk ? ldf(kf + d) : 0.f;
            vj[i] = d < dk ? ldf(kf + a.I + d) : 0.f;
          } else {
            kj[i] = d < dk ? ldb(a.kw + j * jstride + row + d) : 0.f;
            vj[i] = d < dk ? ldb(a.vw + j * jstride + row + d) : 0.f;
          }
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
template <int MODE, int KIND>
__device__ void cross_attn_phase(const Args& a, float* smem, int l) {
  float* qs = smem;                 // MAX_DK q (bf16-rounded in bf16 mode)
  float* qb = qs + MAX_DK;          // MAX_DK int8 q (int modes)
  float* accs = qb + MAX_DK;        // MAX_DK value sums (int modes)
  float* red = accs + MAX_DK;       // NWARPS
  float* sc = red + NWARPS;         // Lenc scores, then probabilities
  int* qi = reinterpret_cast<int*>(qb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dk = a.dk, S = a.Lenc, HB = a.H * a.B;
  for (int item = blockIdx.x; item < HB; item += gridDim.x) {
    const int h = item / a.B, b = item % a.B;
    __syncthreads();
    for (int d = threadIdx.x; d < dk; d += NTHREADS) {
      const float v = ldf(a.q + (size_t)b * a.I + h * dk + d);
      qs[d] = MODE == MODE_BF16 ? bfr(v) : v;
    }
    __syncthreads();
    const size_t pair = pair_index<KIND>(a, l, h, b);
    if (MODE != MODE_BF16) {
      const float qscale = quantize_q(qs, qi, dk, red);
      int_attend<MODE>(a, qi, qscale, a.ck, a.cv, pair * dk * S, S,
                       a.cks + pair * S, a.cvs + pair * S, S, true,
                       -INFINITY, false, sc, red, accs);
      for (int d = threadIdx.x; d < dk; d += NTHREADS)
        a.attn[(size_t)b * a.I + h * dk + d] = f2bf(accs[d]);
      continue;
    }
    const uint16_t* K = static_cast<const uint16_t*>(a.ck) + pair * dk * S;
    const uint16_t* Vv = static_cast<const uint16_t*>(a.cv) + pair * dk * S;
    float lmax = -INFINITY;
    for (int p = threadIdx.x; p < S; p += NTHREADS) {
      float s = 0.f;
      for (int d = 0; d < dk; ++d)
        s = fmaf(qs[d], bf2f(K[(size_t)d * S + p]), s);
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

template <int MODE, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1) fd_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int I = a.I, D = a.D, F = a.F;
  const bool q = MODE != MODE_BF16;   // column scales are read
  if (KIND != KIND_STEP) {            // the step's x arrives filled
    init_phase(a);
    grid.sync();
  }
  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < a.L; ++l) {
      const float* nw = a.norms + (size_t)l * 3 * D;
      matvec_phase<MODE, KIND>(a, smem, D, 3 * I, a.wqkv,
                               (size_t)l * D * 3 * I,
                               q ? a.sqkv + (size_t)l * 3 * I : nullptr,
                               IN_RMS, nw, nullptr, OUT_QKV, nullptr, t, l);
      grid.sync();
      self_attn_phase<MODE, KIND>(a, smem, t, l);
      grid.sync();
      matvec_phase<MODE, KIND>(a, smem, I, D, a.wo, (size_t)l * I * D,
                               q ? a.so + (size_t)l * D : nullptr, IN_BF16,
                               nullptr, a.attn, OUT_RESID, nullptr, t, l);
      grid.sync();
      matvec_phase<MODE, KIND>(a, smem, D, I, a.wqc, (size_t)l * D * I,
                               q ? a.sqc + (size_t)l * I : nullptr, IN_RMS,
                               nw + D, nullptr, OUT_STORE, a.q, t, l);
      grid.sync();
      cross_attn_phase<MODE, KIND>(a, smem, l);
      grid.sync();
      matvec_phase<MODE, KIND>(a, smem, I, D, a.woc, (size_t)l * I * D,
                               q ? a.soc + (size_t)l * D : nullptr, IN_BF16,
                               nullptr, a.attn, OUT_RESID, nullptr, t, l);
      grid.sync();
      matvec_phase<MODE, KIND>(a, smem, D, 2 * F, a.wff_in,
                               (size_t)l * D * 2 * F,
                               q ? a.sff_in + (size_t)l * 2 * F : nullptr,
                               IN_RMS, nw + 2 * D, nullptr, OUT_STORE, a.g,
                               t, l);
      grid.sync();
      matvec_phase<MODE, KIND>(a, smem, F, D, a.wff_out, (size_t)l * F * D,
                               q ? a.sff_out + (size_t)l * D : nullptr,
                               IN_GATED, nullptr, nullptr, OUT_RESID,
                               nullptr, t, l);
      grid.sync();
    }
    matvec_phase<MODE, KIND>(a, smem, D, a.V, a.lm, 0, q ? a.lm_s : nullptr,
                             IN_RMS, a.final_norm, nullptr, OUT_STORE,
                             a.logits, t, 0);
    if (KIND != KIND_STEP) {
      grid.sync();
      argmax_phase(a, smem, t);
      grid.sync();
    }
  }
}

template <int MODE, int KIND>
static int launch(Args a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fd_kernel<MODE, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fd_kernel<MODE, KIND>, NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  dim3 grid(sms), block(NTHREADS);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)fd_kernel<MODE, KIND>, grid, block,
                                    args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// The order of the launchers' pointer and dimension arrays (the Python
// wrappers build them in the same order; a pointer a kind does not read is
// null).
enum Ptr {
  P_EMBED, P_POS_ROWS, P_WQKV, P_WO, P_WQC, P_WOC, P_WFF_IN, P_WFF_OUT,
  P_SQKV, P_SO, P_SQC, P_SOC, P_SFF_IN, P_SFF_OUT, P_NORMS, P_FINAL_NORM,
  P_LM, P_LM_S, P_CK, P_CV, P_CKS, P_CVS, P_KC, P_VC, P_KS, P_VS,
  P_TOKENS_IN, P_FINISHED_IN, P_TOKENS_OUT, P_FINISHED_OUT, P_KW, P_VW,
  P_KQ_OUT, P_VQ_OUT, P_KS_OUT, P_VS_OUT, P_X, P_Q, P_ATTN, P_G, P_LOGITS,
  P_TOK, P_FIN, P_KVF, P_COUNT
};
enum Dim {
  D_B, D_L, D_H, D_DK, D_D, D_F, D_V, D_LENC, D_P, D_T, D_POS0, D_PAD,
  D_EOS, D_MODE, D_CHUNK, D_COUNT
};

// Args from a launcher's arrays; *smem gets the dynamic shared memory the
// kernel needs.
static Args make_args(void* const* p, const int* dim, float eps,
                      size_t* smem) {
  Args a;
  a.B = dim[D_B]; a.L = dim[D_L]; a.H = dim[D_H]; a.dk = dim[D_DK];
  a.D = dim[D_D]; a.I = a.H * a.dk; a.F = dim[D_F]; a.V = dim[D_V];
  a.Lenc = dim[D_LENC]; a.P = dim[D_P]; a.T = dim[D_T];
  a.pos0 = dim[D_POS0]; a.pad_id = dim[D_PAD]; a.eos_id = dim[D_EOS];
  a.qmax = dim[D_MODE] == MODE_INT4 ? 7 : 127;
  a.chunk = dim[D_CHUNK];
  a.eps = eps;
  a.embed = (const uint16_t*)p[P_EMBED];
  a.pos_rows = (const float*)p[P_POS_ROWS];
  a.wqkv = p[P_WQKV]; a.wo = p[P_WO]; a.wqc = p[P_WQC]; a.woc = p[P_WOC];
  a.wff_in = p[P_WFF_IN]; a.wff_out = p[P_WFF_OUT];
  a.sqkv = (const float*)p[P_SQKV]; a.so = (const float*)p[P_SO];
  a.sqc = (const float*)p[P_SQC]; a.soc = (const float*)p[P_SOC];
  a.sff_in = (const float*)p[P_SFF_IN];
  a.sff_out = (const float*)p[P_SFF_OUT];
  a.norms = (const float*)p[P_NORMS];
  a.final_norm = (const float*)p[P_FINAL_NORM];
  a.lm = p[P_LM]; a.lm_s = (const float*)p[P_LM_S];
  a.ck = p[P_CK]; a.cv = p[P_CV];
  a.cks = (const float*)p[P_CKS]; a.cvs = (const float*)p[P_CVS];
  a.kc = p[P_KC]; a.vc = p[P_VC];
  a.ks = (const float*)p[P_KS]; a.vs = (const float*)p[P_VS];
  a.tokens_in = (const int*)p[P_TOKENS_IN];
  a.finished_in = (const int*)p[P_FINISHED_IN];
  a.tokens_out = (int*)p[P_TOKENS_OUT];
  a.finished_out = (int*)p[P_FINISHED_OUT];
  a.kw = (uint16_t*)p[P_KW]; a.vw = (uint16_t*)p[P_VW];
  a.kq_out = (int8_t*)p[P_KQ_OUT]; a.vq_out = (int8_t*)p[P_VQ_OUT];
  a.ks_out = (float*)p[P_KS_OUT]; a.vs_out = (float*)p[P_VS_OUT];
  a.x = (float*)p[P_X]; a.q = (float*)p[P_Q];
  a.attn = (uint16_t*)p[P_ATTN]; a.g = (float*)p[P_G];
  a.logits = (float*)p[P_LOGITS];
  a.tok = (int*)p[P_TOK]; a.fin = (int*)p[P_FIN];
  a.kvf = (float*)p[P_KVF];

  int kmax = a.D > a.I ? a.D : a.I;
  if (a.F > kmax) kmax = a.F;
  const int mv_floats = ROWS * kmax + NWARPS * ROWS * TILE_N;
  const int sc_floats = a.chunk < a.P ? a.chunk : a.P;
  const int att_floats =
      3 * MAX_DK + NWARPS + (sc_floats > a.Lenc ? sc_floats : a.Lenc);
  const int arg_floats = 3 * NWARPS + 1;
  int floats = mv_floats > att_floats ? mv_floats : att_floats;
  if (arg_floats > floats) floats = arg_floats;
  *smem = (size_t)floats * sizeof(float);
  return a;
}
