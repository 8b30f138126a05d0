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
// Design of fd_kernel (now only the bf16 and int8 windows above 8 rows):
// one cooperative persistent launch, one block of 256 threads per SM,
// cg::grid.sync() between phases (8 per layer plus lm_head and argmax). A
// matrix-vector phase (matvec_phase) splits its output into 32-column x
// 8-row tiles over the blocks and streams each tile's weights from L2/HBM
// after the barrier; attention phases give one (row, head) pair to a
// block, one thread per cache row for the score dot through scalar code
// loads, one warp per value component. Each phase is a few dependent L2
// round trips plus a barrier.
//
// Design of fw_kernel<MODE, KIND> (the window up to 8 rows and int4 at
// every B; the step and the grouped window at every B), the same function
// laid out for the H100's 132 SMs and their shared memory:
//   * one block of 256 threads per SM, in clusters of two, a cooperative
//     launch; the grid barrier is a counter with release / acquire at gpu
//     scope (cutlass/barrier.h's pattern), ~1 us a phase on the H100; a
//     wait past 4 s traps;
//   * every projection's output columns are cut into 4-column units dealt
//     round robin over all blocks (wi_0 and wi_1 in pairs, so the gated
//     product is formed where both sums are): N = 384-2048 spread over
//     96-132 blocks. Each block keeps its slice of every layer's int4
//     weights in shared memory for the launch (~95 KB, loaded once); bf16
//     and int8 stream their slices through two shared buffers with
//     cp.async, the next projection's copy issued before the current one
//     runs, so its weights are in flight across the barrier (int8 resident
//     would take ~190 KB, too much beside the rest);
//   * every RMS norm's weights sit in shared memory (read by every block in
//     every RMS phase, from the same L2 lines); the rows' bf16 inputs are
//     staged once per phase as (k, row); at B <= 8 a lane owns one row, at
//     B > 8 a lane decodes 4 weights and multiplies them by 8 rows read with
//     one 16-byte load; codes become f32 through the 2^23 mantissa trick,
//     not I2F (a quarter-rate instruction);
//   * above 8 rows the step and the grouped window take fd_kernel's
//     32-column x 8-row tiles for the projections instead (tile_project),
//     in a kernel of their own (ft_kernel) with this design's barrier and
//     attention: teams of blocks, one an 8-row group staging only its
//     rows, and this layout staging all the rows in every block both
//     measured slower there (PERF.md);
//   * attention reads K/V rows with 16-byte vector loads, VB of them in
//     flight a thread: scores as per-position partial sums in registers
//     (32 int4 / 16 int8 / 8 bf16 positions a load), value sums with
//     __dp4a on int8 probability codes in the int modes. While every (row,
//     head) pair can have a cluster (2 H B <= 132), its cache rows are
//     split between the two blocks; past that the blocks loop over whole
//     pairs. The window attends its cache rows as one chunk: the two
//     blocks agree on the chunk's score max and max |p vs| through
//     distributed shared memory before p is rounded or requantized. The
//     step and the grouped window keep the TPU kernel's flash chunks: a
//     chunk's running max is the prefix max of the chunk maxima, and its
//     rounded p or requantized p vs depend on that alone, so the two
//     blocks take the first and the second half of the chunks, exchange
//     only their chunk maxima, and combine their partial sums as
//     sum_c vals_c exp(M_c - M_last) (attend_chunks: the codes are the
//     sequential update's, the f32 combination another order); each
//     split's V rows are copied to shared memory by cp.async while its K
//     rows load. Cross-attention takes one block a pair;
//   * sums run in a fixed order (shuffle trees, warp order, split order):
//     no float atomics, so a launch is bit-identical run to run;
//   * at B > 8 the two blocks of a cluster stage half the rows' inputs each
//     and copy the other half through distributed shared memory;
//   * the kernel's parameters are grid constants, read in place by the
//     functions that take them by reference (a copy of the ~0.5 KB Args in
//     local memory would cost every phase).
// What it leaves: ~66 phases a step, each a few dependent L2 round trips
// (the activations after a barrier, the residual read-modify-write); no
// tensor cores; the bf16 and int8 weights come from L2 every step. The
// window above 8 rows in bf16 and int8 keeps fd_kernel (every block would
// stage all 64 rows' inputs, measured slower than its 8-row tiles).
// Buffers written inside a launch are read with ld.global.cg or cp.async.cg
// (L2), so no stale L1 line survives a barrier.

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
  // the window kind's own: its grid barrier's counter (zeroed by the
  // wrapper) and the shared memory of its weight slices
  unsigned* sync;
  int wbytes;
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
static __device__ float block_sum(float v, float* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_sum(lane < NWARPS ? red[lane] : 0.f);
}

static __device__ float block_max(float v, float* red) {
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
static __device__ void load_inputs(const Args& a, float* hs, int K, int b0,
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
static __device__ float quantize_q(const float* qs, int* qi, int dk,
                                   float* red) {
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
// norm: probabilities e / sum(e) (cross) or e (cache). out[d] (warp lanes
// 0) receives the dequantized value sums. Returns (max, sum of e).
template <int MODE>
__device__ float2 int_attend(const Args& a, const int* qi, float qscale,
                             const void* K, const void* Vv, size_t base,
                             int rowlen, const float* ksc, const float* vsc,
                             int n, bool norm, float* sc, float* red,
                             float* out) {
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
  const float m = block_max(lmax, red);
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
  for (int d = warp; d < dk; d += NWARPS) {
    int s = 0;
    for (int p = lane; p < n; p += 32)
      s += (int)sc[p] * code_at<MODE>(Vv, base + (size_t)d * rowlen + p);
    s = warp_sum_int(s);
    if (lane == 0) out[d] = (float)s * pscale;
  }
  __syncthreads();
  return make_float2(m, lsum);
}

// bf16 mode: the cache rows as one flash chunk, n positions from element
// offset base of K/V rows of length rowlen, against the bf16-rounded q qb;
// the same contract as int_attend with norm false.
static __device__ float2 bf16_attend(const Args& a, const float* qb,
                              const uint16_t* K, const uint16_t* Vv,
                              int rowlen, int n, float* sc, float* red,
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
  const float m = block_max(lmax, red);
  float ls = 0.f;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    const float e = expf(sc[p] - m);
    ls += e;
    sc[p] = bfr(e);
  }
  const float lsum = block_sum(ls, red);
  for (int d = warp; d < dk; d += NWARPS) {
    const uint16_t* Vd = Vv + (size_t)d * rowlen;
    float s = 0.f;
    for (int p = lane; p < n; p += 32) s = fmaf(sc[p], bf2f(Vd[p]), s);
    s = warp_sum(s);
    if (lane == 0) out[d] = s;
  }
  __syncthreads();
  return make_float2(m, lsum);
}

// Self-attention for one layer (the window): the cache rows < pos0 as one
// flash chunk, then the window rows 0..t.
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
    if (P0 > 0) {
      float2 ml;
      if (MODE == MODE_BF16) {
        const size_t base = pair * dk * a.P;
        ml = bf16_attend(a, qb, static_cast<const uint16_t*>(a.kc) + base,
                         static_cast<const uint16_t*>(a.vc) + base, a.P, P0,
                         sc, red, accs);
      } else {
        ml = int_attend<MODE>(a, qi, qscale, a.kc, a.vc, pair * dk * a.P,
                              a.P, a.ks + pair * a.P, a.vs + pair * a.P, P0,
                              false, sc, red, accs);
      }
      m = ml.x;
      lsum = ml.y;
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
                       a.cks + pair * S, a.cvs + pair * S, S, true, sc, red,
                       accs);
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
static __device__ void embed_row(const Args& a, int b, int token, int t) {
  const bool in_vocab = token >= 0 && token < a.V;
  const uint16_t* e = a.embed + (size_t)(in_vocab ? token : 0) * a.D;
  const float* pr = a.pos_rows + (size_t)t * a.D;
  for (int d = threadIdx.x; d < a.D; d += NTHREADS)
    __stcg(a.x + (size_t)b * a.D + d, (in_vocab ? bf2f(e[d]) : 0.f) + pr[d]);
}

static __device__ void init_phase(const Args& a) {
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
static __device__ void argmax_phase(const Args& a, float* smem, int t) {
  float* bestv = smem;
  int* besti = reinterpret_cast<int*>(smem + NWARPS);
  int* nanw = besti + NWARPS;
  int* next = nanw + NWARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float best = -INFINITY;
    int bi = a.V;
    bool has_nan = false;
    for (int v0 = threadIdx.x; v0 < a.V; v0 += 8 * NTHREADS) {
      float xs[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)          // every load before any use
        xs[u] = ldf(a.logits + (size_t)b * a.V + min(v0 + u * NTHREADS,
                                                      a.V - 1));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int v = v0 + u * NTHREADS;
        if (v >= a.V) break;
        const float x = xs[u];
        has_nan |= x != x;
        if (x > best || (x == best && v < bi)) { best = x; bi = v; }
      }
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
  init_phase(a);
  grid.sync();
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
    grid.sync();
    argmax_phase(a, smem, t);
    grid.sync();
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

// ===========================================================================
// The window kernel (KIND_WINDOW): fw_kernel<MODE>, its phases and launcher.
// ===========================================================================

#define UNIT 4          // output columns of a projection's unit
#define MAX_SUB 4       // 4-column sub-units a block holds per projection

// bytes of one k-row of a 4-column sub-unit's weights
template <int MODE>
__host__ __device__ constexpr int unit_row_bytes() {
  return MODE == MODE_BF16 ? 8 : MODE == MODE_INT8 ? 4 : 2;
}

// positions of a K/V row in one 16-byte load
template <int MODE>
__host__ __device__ constexpr int vec_positions() {
  return MODE == MODE_BF16 ? 8 : MODE == MODE_INT8 ? 16 : 32;
}

// the projections of a layer, then lm_head
enum Proj { PR_QKV, PR_WO, PR_WQC, PR_WOC, PR_FFIN, PR_FFOUT, PR_LM };

struct ProjShape {
  int K, N, units;   // rows, columns, 4-column units (pairs for FFIN)
  bool paired;       // FFIN: unit u is columns 4u.. of wi_0 and of wi_1
};

__host__ __device__ inline ProjShape proj_shape(const Args& a, int m) {
  switch (m) {
    case PR_QKV: return {a.D, 3 * a.I, 3 * a.I / UNIT, false};
    case PR_WO: return {a.I, a.D, a.D / UNIT, false};
    case PR_WQC: return {a.D, a.I, a.I / UNIT, false};
    case PR_WOC: return {a.I, a.D, a.D / UNIT, false};
    case PR_FFIN: return {a.D, 2 * a.F, a.F / UNIT, true};
    case PR_FFOUT: return {a.F, a.D, a.D / UNIT, false};
    default: return {a.D, a.V, a.V / UNIT, false};
  }
}

// sub-units of projection s that block blk of G holds: units blk, blk + G, ...
__host__ __device__ inline int proj_subunits(const ProjShape& s, int blk,
                                             int G) {
  const int units = blk < s.units ? (s.units - blk + G - 1) / G : 0;
  return s.paired ? 2 * units : units;
}

// first output column of the block's sub-unit i
__device__ __forceinline__ int sub_col0(const ProjShape& s, int blk, int G,
                                        int i, int F) {
  return s.paired ? UNIT * (blk + (i / 2) * G) + (i % 2) * F
                  : UNIT * (blk + i * G);
}

template <int MODE>
__host__ __device__ inline size_t slice_bytes(const ProjShape& s, int nsub) {
  return ((size_t)nsub * s.K * unit_row_bytes<MODE>() + 15) / 16 * 16;
}

// the bytes of element e of a bf16, int8 or packed int4 array
template <int MODE>
__device__ __forceinline__ const uint8_t* elem_ptr(const void* base,
                                                   size_t e) {
  return static_cast<const uint8_t*>(base) +
         (MODE == MODE_BF16 ? 2 * e : MODE == MODE_INT8 ? e : e / 2);
}

__device__ __forceinline__ const void* proj_weights(const Args& a, int m) {
  switch (m) {
    case PR_QKV: return a.wqkv;
    case PR_WO: return a.wo;
    case PR_WQC: return a.wqc;
    case PR_WOC: return a.woc;
    case PR_FFIN: return a.wff_in;
    case PR_FFOUT: return a.wff_out;
    default: return a.lm;
  }
}

__device__ __forceinline__ const float* proj_scales(const Args& a, int m) {
  switch (m) {
    case PR_QKV: return a.sqkv;
    case PR_WO: return a.so;
    case PR_WQC: return a.sqc;
    case PR_WOC: return a.soc;
    case PR_FFIN: return a.sff_in;
    case PR_FFOUT: return a.sff_out;
    default: return a.lm_s;
  }
}

// Byte offset of projection m of layer l among a block's resident slices
// (int4): layer after layer, then lm_head.
template <int MODE>
__host__ __device__ inline size_t resident_offset(const Args& a, int m, int l,
                                                  int blk, int G) {
  size_t off = 0, per_layer = 0;
  for (int j = PR_QKV; j < PR_LM; ++j) {
    const ProjShape s = proj_shape(a, j);
    const size_t sz = slice_bytes<MODE>(s, proj_subunits(s, blk, G));
    if (j < m) off += sz;
    per_layer += sz;
  }
  return m == PR_LM ? (size_t)a.L * per_layer : (size_t)l * per_layer + off;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy the block's slice of projection m, layer l, into dst as [sub-unit][k]
// rows of unit_row_bytes: with cp.async (bf16 8 bytes, int8 4 bytes a row;
// the caller commits) or with plain loads (int4's 2 bytes, once a launch,
// 8 of a thread in flight).
template <int MODE, bool ASYNC>
__device__ void copy_slice(const Args& a, int m, int l, uint8_t* dst) {
  const ProjShape s = proj_shape(a, m);
  const int G = gridDim.x, blk = blockIdx.x;
  const int nsub = proj_subunits(s, blk, G);
  const size_t first = m == PR_LM ? 0 : (size_t)l * s.K * s.N;
  const void* W = proj_weights(a, m);
  constexpr int RB = unit_row_bytes<MODE>();
  if (!ASYNC) {                 // plain loads, 8 of a thread in flight
    const int total = nsub * s.K;
    for (int i0 = threadIdx.x; i0 < total; i0 += 8 * NTHREADS) {
      uint16_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = min(i0 + u * NTHREADS, total - 1);
        v[u] = __ldg(reinterpret_cast<const unsigned short*>(elem_ptr<MODE>(
            W, first + (size_t)(i % s.K) * s.N +
                   sub_col0(s, blk, G, i / s.K, a.F))));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u * NTHREADS < total)
          reinterpret_cast<uint16_t*>(dst)[i0 + u * NTHREADS] = v[u];
    }
    return;
  }
  for (int i = threadIdx.x; i < nsub * s.K; i += NTHREADS) {
    const int sub = i / s.K, k = i % s.K;
    const uint8_t* src = elem_ptr<MODE>(
        W, first + (size_t)k * s.N + sub_col0(s, blk, G, sub, a.F));
    uint8_t* d = dst + (size_t)i * RB;
    const unsigned sa = (unsigned)__cvta_generic_to_shared(d);
    if (RB == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                   "l"(src));
  }
}

#define MAX_D 512       // d_model limit of the RMS rows held in registers
#define HCAP 36864      // bf16 activations a projection stages at a time

// the f32 value of a two's-complement int4 nibble n (0..15) and of an int8
// byte b (0..255): exact, through the 2^23 mantissa trick (integer ops and
// one FADD, all at full rate, where I2F runs at a quarter)
__device__ __forceinline__ float nibble_f(uint32_t n) {
  return __int_as_float(0x4b000000 | ((n & 0xfu) ^ 0x8u)) - 8388616.f;
}
__device__ __forceinline__ float byte_f(uint32_t b) {
  return __int_as_float(0x4b000000 | ((b & 0xffu) ^ 0x80u)) - 8388736.f;
}

// the 4 weights of one k-row of a sub-unit, as f32
template <int MODE>
__device__ __forceinline__ void load_w4(const uint8_t* p, float w[UNIT]) {
  if (MODE == MODE_BF16) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = __uint_as_float(v.x << 16);
    w[1] = __uint_as_float(v.x & 0xffff0000u);
    w[2] = __uint_as_float(v.y << 16);
    w[3] = __uint_as_float(v.y & 0xffff0000u);
  } else if (MODE == MODE_INT8) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int c = 0; c < UNIT; ++c) w[c] = byte_f(v >> (8 * c));
  } else {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int c = 0; c < UNIT; ++c) w[c] = nibble_f(v >> (4 * c));
  }
}

// rs[row] = 1 / sqrt(mean(x^2) + eps) of the batch rows lo..hi-1: a warp a
// row, four rows of a warp at a time with all their loads in flight (the
// sum in load_inputs' order)
static __device__ void row_rms(const Args& a, float* rs, int lo, int hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = lo + warp; r0 < hi; r0 += 4 * NWARPS) {
    float v[4][MAX_D / 32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {          // every load before any use
      const int row = min(r0 + j * NWARPS, hi - 1);
      const float* xr = a.x + (size_t)row * a.D;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i)
        v[j][i] = ldf(xr + min(lane + 32 * i, a.D - 1));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i)
        if (lane + 32 * i < a.D) ss = fmaf(v[j][i], v[j][i], ss);
      ss = warp_sum(ss);
      const int row = r0 + j * NWARPS;
      if (lane == 0 && row < hi) rs[row] = rsqrtf(ss / (float)a.D + a.eps);
    }
  }
}

// h (kc, bpad) bf16 <- the bf16-rounded inputs of batch rows lo..hi-1,
// input columns k0..k0+kc (a multiple of 8): the RMS-normalized residual
// (norm, in shared memory, given; rs from row_rms) or a bf16 row of in16 (K
// wide). 16-byte loads, AB items of a thread in flight before their
// stores, rows fastest so that the transposed stores do not collide. Rows
// past B are left as they are: their outputs are never stored.
#define AB 4
static __device__ void load_acts(const Args& a, uint16_t* h, int bpad,
                                 int K, int k0, int kc, const float* norm,
                                 const float* rs, const uint16_t* in16,
                                 int lo, int hi) {
  const int nr = hi - lo, total = nr * (kc / 8);
  for (int i0 = threadIdx.x; i0 < total; i0 += AB * NTHREADS) {
    uint4 raw[AB][2];
#pragma unroll
    for (int u = 0; u < AB; ++u) {          // every load before any use
      const int i = min(i0 + u * NTHREADS, total - 1);
      const int row = lo + i % nr, k = k0 + 8 * (i / nr);
      if (norm != nullptr) {
        const uint4* xr =
            reinterpret_cast<const uint4*>(a.x + (size_t)row * a.D + k);
        raw[u][0] = __ldcg(xr);
        raw[u][1] = __ldcg(xr + 1);
      } else {
        raw[u][0] = __ldcg(
            reinterpret_cast<const uint4*>(in16 + (size_t)row * K + k));
      }
    }
#pragma unroll
    for (int u = 0; u < AB; ++u) {
      const int i = i0 + u * NTHREADS;
      if (i >= total) continue;
      const int row = lo + i % nr, kv = i / nr, k = k0 + 8 * kv;
      uint16_t v[8];
      if (norm != nullptr) {
        const uint32_t xw[8] = {raw[u][0].x, raw[u][0].y, raw[u][0].z,
                                raw[u][0].w, raw[u][1].x, raw[u][1].y,
                                raw[u][1].z, raw[u][1].w};
        const float r = rs[row];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = f2bf(norm[k + e] * (__uint_as_float(xw[e]) * r));
      } else {
        const uint32_t w[4] = {raw[u][0].x, raw[u][0].y, raw[u][0].z,
                               raw[u][0].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[2 * e] = (uint16_t)(w[e] & 0xffffu);
          v[2 * e + 1] = (uint16_t)(w[e] >> 16);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) h[(8 * kv + e) * bpad + row] = v[e];
    }
  }
}

// B <= 8: the RMS rows in one pass, a warp a row, the row held in registers
// between its sum and its scaling (the same arithmetic as row_rms).
static __device__ void load_rms_rows(const Args& a, uint16_t* h, int bpad,
                              const float* norm) {
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (row >= a.B) return;
  const float* xr = a.x + (size_t)row * a.D;
  float v[MAX_D / 32];
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i)     // every load before any use
    v[i] = ldf(xr + min(lane + 32 * i, a.D - 1));
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i)
    if (lane + 32 * i < a.D) ss = fmaf(v[i], v[i], ss);
  ss = warp_sum(ss);
  const float rs = rsqrtf(ss / (float)a.D + a.eps);
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const int k = lane + 32 * i;
    if (k < a.D) h[k * bpad + row] = f2bf(norm[k] * (v[i] * rs));
  }
}

// the padded row stride of h: 16-byte rows of 8 batch rows an odd number
// of 16-byte units apart, so that 8 lanes at 8 consecutive k read 8
// distinct bank quads
__host__ __device__ inline int h_stride(int bp) {
  return (bp / 8) % 2 ? bp : bp + 8;
}

// One projection over the block's sub-units (weights wsl, norms normsm in
// shared memory) for all batch rows at once. The rows' bf16 inputs are
// staged as (k, row) in shared memory, in chunks of k when they exceed
// HCAP. The 8 warps are split between the row groups of 8 and parts of k.
// B <= 8: lane (slot, row) of a warp sums every kstep-th k of its
// sub-unit's 4 columns for its row. B > 8: lane (slot, kk) decodes the 4
// weights of its sub-unit at k = kk, kk + 8, ... of its slice and
// multiplies them by the 8 rows of its group, read with one 16-byte load.
// The lanes of a sub-unit are summed by a fixed shuffle tree, the k-parts
// of a row group in warp order by one thread an output, which scales,
// routes and stores it.
template <int MODE, int KIND>
__device__ void fw_project(const Args& a, int m, int l, int t,
                           const uint8_t* wsl, const float* normsm,
                           float* un, int hcap) {
  const ProjShape s = proj_shape(a, m);
  const int G = gridDim.x, blk = blockIdx.x;
  const int nsub = proj_subunits(s, blk, G);
  const bool one_row = a.B <= ROWS;            // a lane a row (kk = row)
  // B > 8: the two blocks of a cluster stage half the rows each and copy
  // the other half from each other's shared memory (half the L2 reads)
  if (nsub == 0 && (one_row || proj_subunits(s, blk ^ 1, G) == 0)) return;
  constexpr int RB = unit_row_bytes<MODE>();
  uint16_t* h = reinterpret_cast<uint16_t*>(un);        // [kc][bpad]
  float* red = un + hcap / 2;                           // [NWARPS][4][32]
  float* rs = red + NWARPS * 4 * ROWS * UNIT;           // [B]
  const float* norm = nullptr;
  const uint16_t* in16 = nullptr;
  switch (m) {
    case PR_QKV: norm = normsm + (size_t)l * 3 * a.D; break;
    case PR_WQC: norm = normsm + (size_t)l * 3 * a.D + a.D; break;
    case PR_FFIN: norm = normsm + (size_t)l * 3 * a.D + 2 * a.D; break;
    case PR_LM: norm = normsm + (size_t)a.L * 3 * a.D; break;
    case PR_FFOUT: in16 = reinterpret_cast<const uint16_t*>(a.g); break;
    default: in16 = a.attn; break;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ng = (a.B + ROWS - 1) / ROWS, bpad = h_stride(ng * ROWS);
  const int gp2 = ng <= 1 ? 1 : ng <= 2 ? 2 : ng <= 4 ? 4 : 8;
  const int wpg = NWARPS / gp2, g = warp / wpg, kp = warp % wpg;
  const int slot = lane >> 3, kk = lane & 7;
  const int np2 = nsub <= 1 ? 1 : nsub <= 2 ? 2 : 4;
  const int nks = 4 / np2, sub = slot / nks, ks = slot % nks;
  const int k_first = one_row ? kp * nks + ks : (kp * nks + ks) * 8 + kk;
  const int kstep = one_row ? wpg * nks : wpg * nks * 8;
  const bool live = sub < nsub && g < ng;
  const uint8_t* wsub = wsl + (size_t)sub * s.K * RB;
  const int KC = (hcap / bpad) / 8 * 8;
  const int rank = blk & 1, half = (a.B + 15) / 16 * 8;
  const int lo = one_row ? 0 : min(a.B, rank * half);
  const int hi = one_row ? a.B : min(a.B, lo + half);
  const int plo = min(a.B, (rank ^ 1) * half), phi = min(a.B, plo + half);
  cg::cluster_group cl = cg::this_cluster();
  if (norm != nullptr && !one_row) {
    row_rms(a, rs, lo, hi);
    cl.sync();
    const float* prs = cl.map_shared_rank(rs, rank ^ 1);
    for (int r = plo + tid; r < phi; r += NTHREADS) rs[r] = prs[r];
    __syncthreads();
  }
  float acc[ROWS][UNIT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < UNIT; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < s.K; k0 += KC) {
    const int kc = min(KC, s.K - k0);
    if (one_row) {
      __syncthreads();                                  // h is free
      if (norm != nullptr)
        load_rms_rows(a, h, bpad, norm);
      else
        load_acts(a, h, bpad, s.K, k0, kc, norm, rs, in16, 0, a.B);
    } else {
      if (k0 > 0) cl.sync();          // the other block copied our half
      else __syncthreads();
      load_acts(a, h, bpad, s.K, k0, kc, norm, rs, in16, lo, hi);
      cl.sync();                      // both halves staged
      const uint16_t* ph = cl.map_shared_rank(h, rank ^ 1);
      const int pn = phi - plo;
      if (nsub > 0 && pn > 0) {
        if (pn % 8 == 0) {            // plo is a multiple of 8: 16 bytes
          const int nv = pn / 8, total = kc * nv;
          for (int i0 = tid; i0 < total; i0 += 8 * NTHREADS) {
            uint4 w[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {  // every load before any use
              const int i = min(i0 + u * NTHREADS, total - 1);
              w[u] = *reinterpret_cast<const uint4*>(
                  ph + (i / nv) * bpad + plo + 8 * (i % nv));
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int i = i0 + u * NTHREADS;
              if (i < total)
                *reinterpret_cast<uint4*>(h + (i / nv) * bpad + plo +
                                          8 * (i % nv)) = w[u];
            }
          }
        } else {
          for (int i = tid; i < kc * pn; i += NTHREADS) {
            const int k = i / pn, r = plo + i % pn;
            h[k * bpad + r] = ph[k * bpad + r];
          }
        }
      }
    }
    __syncthreads();
    if (nsub == 0) continue;
    if (live && one_row) {
#pragma unroll 4
      for (int k = k_first; k < kc; k += kstep) {
        const float hv = bf2f(h[k * bpad + kk]);
        float w[UNIT];
        load_w4<MODE>(wsub + (size_t)(k0 + k) * RB, w);
#pragma unroll
        for (int c = 0; c < UNIT; ++c) acc[0][c] = fmaf(hv, w[c], acc[0][c]);
      }
    } else if (live) {
#pragma unroll 2
      for (int k = k_first; k < kc; k += kstep) {
        const uint4 hv = *reinterpret_cast<const uint4*>(h + k * bpad +
                                                         ROWS * g);
        const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
        float w[UNIT];
        load_w4<MODE>(wsub + (size_t)(k0 + k) * RB, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float h0 = __uint_as_float(hw[q] << 16);
          const float h1 = __uint_as_float(hw[q] & 0xffff0000u);
#pragma unroll
          for (int c = 0; c < UNIT; ++c) {
            acc[2 * q][c] = fmaf(h0, w[c], acc[2 * q][c]);
            acc[2 * q + 1][c] = fmaf(h1, w[c], acc[2 * q + 1][c]);
          }
        }
      }
    }
  }
  if (nsub == 0) return;
  if (one_row) {
    // the k-slots of a sub-unit: lanes 8 and 16 apart, in a fixed order
#pragma unroll
    for (int c = 0; c < UNIT; ++c) {
      if (nks >= 2) acc[0][c] += __shfl_xor_sync(0xffffffffu, acc[0][c], 8);
      if (nks >= 4) acc[0][c] += __shfl_xor_sync(0xffffffffu, acc[0][c], 16);
    }
    if (ks == 0) {
#pragma unroll
      for (int c = 0; c < UNIT; ++c)
        red[((warp * 4 + slot) * ROWS + kk) * UNIT + c] = acc[0][c];
    }
  } else {
    // the 8 kk lanes, then the k-slots of a sub-unit: a fixed shuffle tree
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < UNIT; ++c) {
        float v = acc[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        if (nks >= 2) v += __shfl_xor_sync(0xffffffffu, v, 8);
        if (nks >= 4) v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][c] = v;
      }
    if (kk == 0 && ks == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < UNIT; ++c)
          red[((warp * 4 + slot) * ROWS + r) * UNIT + c] = acc[r][c];
    }
  }
  __syncthreads();
  const int nout = s.paired ? nsub / 2 : nsub;
  const float* scale = proj_scales(a, m) + (m == PR_LM ? 0 : (size_t)l * s.N);
  for (int o = tid; o < a.B * nout * UNIT; o += NTHREADS) {
    const int c = o % UNIT, i = (o / UNIT) % nout, gb = o / (UNIT * nout);
    const int og = gb / ROWS, ob = gb % ROWS;
    auto total = [&](int si) {
      float v = 0.f;
      for (int k2 = 0; k2 < wpg; ++k2)
        v += red[(((og * wpg + k2) * 4 + si * nks) * ROWS + ob) * UNIT + c];
      return v;
    };
    if (s.paired) {                             // FFIN: the gated product
      const int n = sub_col0(s, blk, G, 2 * i, a.F) + c;
      float g0 = total(2 * i), g1 = total(2 * i + 1);
      if (MODE != MODE_BF16) {
        g0 *= __ldg(scale + n);
        g1 *= __ldg(scale + a.F + n);
      }
      reinterpret_cast<uint16_t*>(a.g)[(size_t)gb * a.F + n] =
          f2bf(gelu_new(g0) * g1);
      continue;
    }
    const int n = sub_col0(s, blk, G, i, a.F) + c;
    float v = total(i);
    if (MODE != MODE_BF16) v *= __ldg(scale + n);
    if (m == PR_QKV) {
      if (n < a.I) {
        __stcg(a.q + (size_t)gb * a.I + n, v);
      } else {
        const int nn = (n - a.I) % a.I;
        uint16_t* dst = (n < 2 * a.I) ? a.kw : a.vw;
        const int hb = (nn / a.dk) * a.B + gb;
        dst[(((size_t)t * a.L + l) * a.H * a.B + hb) * a.dk + nn % a.dk] =
            f2bf(v);
        if (MODE != MODE_BF16 || KIND == KIND_STEP)
          __stcg(a.kvf + (size_t)gb * 2 * a.I + (n - a.I), v);
      }
    } else if (m == PR_WQC) {
      __stcg(a.q + (size_t)gb * a.I + n, v);
    } else if (m == PR_LM) {
      __stcg(a.logits + (size_t)gb * a.V + n, v);
    } else {                                    // WO, WOC, FFOUT: residual
      float* px = a.x + (size_t)gb * a.D + n;
      __stcg(px, ldf(px) + v);
    }
  }
}

// 16 bytes of a K/V row from element e: one vector load when aligned and
// holding `valid` >= its positions, else byte loads of the valid bytes
// (the rest zero).
template <int MODE>
__device__ __forceinline__ uint4 load_vec(const void* base, size_t e,
                                          int valid) {
  constexpr int EP = vec_positions<MODE>();
  const uint8_t* p = elem_ptr<MODE>(base, e);
  if (valid >= EP && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int nbytes = MODE == MODE_BF16 ? 2 * valid
                     : MODE == MODE_INT8 ? valid : (valid + 1) / 2;
  for (int i = 0; i < nbytes; ++i)
    w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// padded index of position p in the score array (no bank conflicts when
// consecutive threads take consecutive 16-byte vectors)
__device__ __forceinline__ int sci(int p) { return p + (p >> 5); }

// Scores of n positions of a (row, head)'s K rows (row d at element base +
// d * stride): each item is one 16-byte vector (EP positions) of the rows
// d = dg, dg + DG, ...; its EP partial sums stay in registers and go to
// part[e][dg][c], which is summed over dg in a fixed order into
// sc[sci(p)]: bf16 the f32 dot with the rounded q qf, int the int32 dot
// with qi times qscale times ksc[p] (staged in shared memory by the
// caller). An item's vectors are loaded VB at a time before they are used,
// so that VB loads are in flight a thread. Returns this thread's max.
#define VB 8
template <int MODE>
__device__ __forceinline__ void score_vec(const uint4 v, float qf, int qi,
                                          float* accf, int* acci) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (MODE == MODE_BF16) {
      accf[2 * j] = fmaf(qf, __uint_as_float(u[j] << 16), accf[2 * j]);
      accf[2 * j + 1] =
          fmaf(qf, __uint_as_float(u[j] & 0xffff0000u), accf[2 * j + 1]);
    } else if (MODE == MODE_INT8) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acci[4 * j + i] += qi * (int)(int8_t)(u[j] >> (8 * i));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acci[8 * j + i] += qi * ((int)(u[j] << (28 - 4 * i)) >> 28);
    }
  }
}

// whether every row's 16-byte vectors are 16-byte aligned: the rows start
// at element base + d * stride
template <int MODE>
__device__ __forceinline__ bool rows_aligned(const void* X, size_t base,
                                             int stride) {
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(elem_ptr<MODE>(X, base));
  const uintptr_t b1 =
      reinterpret_cast<uintptr_t>(elem_ptr<MODE>(X, base + stride));
  return ((b0 | b1) & 15) == 0;
}

template <int MODE>
__device__ float fw_scores(const Args& a, const void* K, size_t base,
                           int stride, int n, const float* qf, const int* qi,
                           float qscale, const float* ksc, float* part,
                           float* sc) {
  constexpr int EP = vec_positions<MODE>();
  constexpr int AE = MODE == MODE_BF16 ? EP : 1;   // f32 accumulators
  constexpr int AI = MODE == MODE_BF16 ? 1 : EP;   // int32 accumulators
  const int dk = a.dk, C = (n + EP - 1) / EP;
  const int DG = max(1, min(dk, NTHREADS / max(C, 1)));
  const int cols = DG * C;                      // part's row length
  const bool aligned = rows_aligned<MODE>(K, base, stride);
  int* ipart = reinterpret_cast<int*>(part);
  for (int item = threadIdx.x; item < cols; item += NTHREADS) {
    const int c = item % C, dg = item / C;
    const int valid = min(EP, n - c * EP);
    float accf[AE];
    int acci[AI];
#pragma unroll
    for (int e = 0; e < AE; ++e) accf[e] = 0.f;
#pragma unroll
    for (int e = 0; e < AI; ++e) acci[e] = 0;
    const size_t off = base + (size_t)c * EP;
    int d = dg;
    if (aligned && valid == EP) {
      for (; d < dk; d += VB * DG) {
        uint4 v[VB];
#pragma unroll
        for (int u = 0; u < VB; ++u)       // every load before any use
          v[u] = *reinterpret_cast<const uint4*>(elem_ptr<MODE>(
              K, off + (size_t)min(d + u * DG, dk - 1) * stride));
#pragma unroll
        for (int u = 0; u < VB; ++u)
          if (d + u * DG < dk)
            score_vec<MODE>(v[u], MODE == MODE_BF16 ? qf[d + u * DG] : 0.f,
                            MODE == MODE_BF16 ? 0 : qi[d + u * DG], accf,
                            acci);
      }
    }
    for (; d < dk; d += DG)
      score_vec<MODE>(load_vec<MODE>(K, off + (size_t)d * stride, valid),
                      MODE == MODE_BF16 ? qf[d] : 0.f,
                      MODE == MODE_BF16 ? 0 : qi[d], accf, acci);
    if (MODE == MODE_BF16) {
#pragma unroll
      for (int e = 0; e < EP; ++e) part[e * cols + item] = accf[e % AE];
    } else {
#pragma unroll
      for (int e = 0; e < EP; ++e) ipart[e * cols + item] = acci[e % AI];
    }
  }
  if (MODE != MODE_BF16) cp_async_wait_all();   // ksc staged by the caller
  __syncthreads();
  float lmax = -INFINITY;
  for (int i = threadIdx.x; i < C * EP; i += NTHREADS) {
    const int c = i % C, e = i / C, p = c * EP + e;
    if (p >= n) continue;
    float sf;
    if (MODE == MODE_BF16) {
      sf = 0.f;
      for (int dg = 0; dg < DG; ++dg) sf += part[e * cols + dg * C + c];
    } else {
      int si = 0;
      for (int dg = 0; dg < DG; ++dg) si += ipart[e * cols + dg * C + c];
      sf = ((float)si * qscale) * ksc[p];
    }
    sc[sci(p)] = sf;
    lmax = fmaxf(lmax, sf);
  }
  return lmax;
}

// index of position p among int8 probability codes laid out for int4 value
// rows: in each 8 positions the even ones, then the odd ones
template <int MODE>
__device__ __forceinline__ int code_slot(int p) {
  return MODE == MODE_INT4 ? (p & ~7) | ((p & 1) << 2) | ((p & 7) >> 1) : p;
}

template <int MODE>
__device__ __forceinline__ void value_vec(const uint4 v, int c,
                                          const float* pf, const int8_t* pc,
                                          float& accf, int& acci) {
  constexpr int EP = vec_positions<MODE>();
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if (MODE == MODE_BF16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      accf = fmaf(pf[sci(c * EP + 2 * q)], __uint_as_float(u[q] << 16), accf);
      accf = fmaf(pf[sci(c * EP + 2 * q + 1)],
                  __uint_as_float(u[q] & 0xffff0000u), accf);
    }
  } else {
    const int* pw = reinterpret_cast<const int*>(pc + c * EP);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (MODE == MODE_INT8) {
        acci = __dp4a((int)u[q], pw[q], acci);
      } else {
        const unsigned lo =
            __vsub4((u[q] & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
        const unsigned hi =
            __vsub4(((u[q] >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
        acci = __dp4a((int)lo, pw[2 * q], acci);
        acci = __dp4a((int)hi, pw[2 * q + 1], acci);
      }
    }
  }
}

// Value sums of n positions of a (row, head)'s V rows against the
// probabilities: bf16 f32 products with pf[sci(p)] (zero past n), int
// __dp4a over the int8 codes pc (code_slot order, zero past n). TPD
// threads a component take every TPD-th 16-byte vector, VB loads in flight,
// then sum over a fixed shuffle tree. Component d's sum goes to outf[d] or
// outi[d].
template <int MODE>
__device__ void fw_values(const Args& a, const void* V, size_t base,
                          int stride, int n, const float* pf,
                          const int8_t* pc, float* outf, int* outi) {
  constexpr int EP = vec_positions<MODE>();
  const int dk = a.dk, C = (n + EP - 1) / EP;
  int dkp = 8;
  while (dkp < dk) dkp <<= 1;
  const int TPD = NTHREADS / dkp;               // a power of two <= 32
  const int d = threadIdx.x / TPD, j = threadIdx.x % TPD;
  float accf = 0.f;
  int acci = 0;
  if (d < dk) {
    const size_t row = base + (size_t)d * stride;
    const bool aligned = rows_aligned<MODE>(V, base, stride);
    const int full = n / EP;                    // whole vectors
    int c = j;
    if (aligned && full > 0) {
      for (; c < full; c += VB * TPD) {
        uint4 v[VB];
#pragma unroll
        for (int u = 0; u < VB; ++u)       // every load before any use
          v[u] = *reinterpret_cast<const uint4*>(elem_ptr<MODE>(
              V, row + (size_t)min(c + u * TPD, full - 1) * EP));
#pragma unroll
        for (int u = 0; u < VB; ++u)
          if (c + u * TPD < full)
            value_vec<MODE>(v[u], c + u * TPD, pf, pc, accf, acci);
      }
      // the batches overshoot: step back to the first vector not taken
      c = full + ((j - full) % TPD + TPD) % TPD;
    }
    for (; c < C; c += TPD)
      value_vec<MODE>(load_vec<MODE>(V, row + (size_t)c * EP,
                                     min(EP, n - c * EP)),
                      c, pf, pc, accf, acci);
  }
  for (int o = TPD / 2; o > 0; o >>= 1) {
    accf += __shfl_xor_sync(0xffffffffu, accf, o);
    acci += __shfl_xor_sync(0xffffffffu, acci, o);
  }
  if (j == 0 && d < dk) {
    if (MODE == MODE_BF16) outf[d] = accf;
    else outi[d] = acci;
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier: after __syncthreads, thread 0 adds its block's arrival
// to sync[0] with release semantics at gpu scope and spins with acquire
// loads until every block of this epoch arrived; __syncthreads then passes
// the ordering to the block's other threads (cutlass/barrier.h's pattern).
// A wait that outlasts SPIN_LIMIT_NS traps, so that a barrier some block
// never reaches ends the launch with an error instead of hanging the card.
#define SPIN_LIMIT_NS 4000000000ull
#ifdef PHASE_TRACE
// a probe build (-DPHASE_TRACE): block 0 stamps %globaltimer as it leaves
// each barrier; read with <prefix>_phase_trace
#define PHASE_TRACE_MAX 4096
static __device__ unsigned long long g_phase_ns[PHASE_TRACE_MAX];
#endif
__device__ __forceinline__ void grid_barrier(const Args& a, unsigned& epoch) {
  ++epoch;
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release_add(a.sync, 1u);
    const unsigned target = epoch * gridDim.x;
    const unsigned long long t0 = global_ns();
    while (ld_acquire(a.sync) < target) {
      if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
    }
#ifdef PHASE_TRACE
    if (blockIdx.x == 0 && epoch < PHASE_TRACE_MAX)
      g_phase_ns[epoch] = global_ns();
#endif
  }
  __syncthreads();
}

// cache chunks one block of a pair attends (the step, the grouped window)
#define MAXC 4
#define CHUNK_FLOATS (2 * NWARPS * MAXC + 6 * MAXC + 2 * MAX_DK)

#ifdef PHASE_TRACE
#define ASTAMP(k) \
  if (stamp && threadIdx.x == 0) g_phase_ns[2048 + (k)] = global_ns();
#else
#define ASTAMP(k)
#endif

// attention scratch in the union region
struct AttnSmem {
  float* qs;     // MAX_DK f32 q
  float* qf;     // MAX_DK bf16-rounded q (int modes: int8 q as int)
  float* accs;   // MAX_DK f32 value sums
  int* acci;     // MAX_DK int32 value sums
  float* xch;    // 4 + MAX_DK: what the other block of the cluster reads
  float* red;    // 32
  float* red2;   // NWARPS * MAXC: per-chunk block reductions
  float* red3;   // NWARPS * MAXC
  float* cxm;    // MAXC: this block's chunk maxima (the other block reads)
  float* gm;     // 2 * MAXC: every chunk's running max
  float* lsc;    // MAXC: this block's chunks' sums of exp(s - m)
  float* psc;    // MAXC: their probability codes' scales
  float* cw;     // MAXC: their weights exp(m_c - m_last)
  float* kvd;    // 2 * MAX_DK: the step's own f32 k and v
  uint8_t* vrows;  // the chunked kinds' V rows of a split, [d][vector]
  float* ksm;    // the split's K scales (int modes), nmax + 64
  float* vsm;    // its V scales
  float* sc;     // scores, then probabilities (sci layout)
  int8_t* pc;    // probability codes
  float* part;   // score partials; then the window rows
};

__device__ __forceinline__ AttnSmem attn_smem(float* un, int nmax,
                                              int vfloats) {
  AttnSmem m;
  m.vrows = reinterpret_cast<uint8_t*>(un);
  un += vfloats;
  m.qs = un;
  m.qf = m.qs + MAX_DK;
  m.accs = m.qf + MAX_DK;
  m.acci = reinterpret_cast<int*>(m.accs + MAX_DK);
  m.xch = m.accs + 2 * MAX_DK;
  m.red = m.xch + 4 + MAX_DK;
  m.red2 = m.red + 32;
  m.red3 = m.red2 + NWARPS * MAXC;
  m.cxm = m.red3 + NWARPS * MAXC;
  m.gm = m.cxm + MAXC;
  m.lsc = m.gm + 2 * MAXC;
  m.psc = m.lsc + MAXC;
  m.cw = m.psc + MAXC;
  m.kvd = m.cw + MAXC;
  m.ksm = m.red + 32 + CHUNK_FLOATS;
  m.vsm = m.ksm + nmax + 64;
  m.sc = m.vsm + nmax + 64;
  const int scn = (nmax + 64) / 32 * 33;
  m.pc = reinterpret_cast<int8_t*>(m.sc + scn);
  m.part = m.sc + scn + (nmax + 64) / 4;
  return m;
}

// the cache positions one block of a pair attends at most on a grid of G:
// the window's split of the rows, or the step's and the grouped window's
// whole chunks a split (-1 past MAXC chunks)
template <int MODE, int KIND>
__host__ __device__ inline int self_positions(const Args& a, int G) {
  constexpr int EP = vec_positions<MODE>();
  const int nsplit = 2 * a.H * a.B <= G ? 2 : 1;
  if (KIND == KIND_WINDOW)
    return ((a.pos0 + nsplit - 1) / nsplit + EP - 1) / EP * EP;
  const int nc = (a.pos0 + a.chunk - 1) / a.chunk;
  const int cmid = nsplit == 2 ? (nc + 1) / 2 : nc;
  if (cmid > MAXC) return -1;
  const int most = cmid * a.chunk < a.pos0 ? cmid * a.chunk : a.pos0;
  return (most + EP - 1) / EP * EP;
}

// floats of the chunked kinds' V rows of a split in shared memory (16-byte
// vectors of dk rows); none for the window
template <int MODE, int KIND>
__host__ __device__ inline int vrow_floats(const Args& a, int G) {
  if (KIND == KIND_WINDOW) return 0;
  const int n = self_positions<MODE, KIND>(a, G);
  return n < 0 ? 0 : a.dk * (n / vec_positions<MODE>()) * 4;
}

// floats of AttnSmem for nmax positions a split and part_floats partials
__host__ __device__ inline int attn_floats(int nmax, int part_floats) {
  return 5 * MAX_DK + 4 + 32 + CHUNK_FLOATS + 2 * (nmax + 64) +
         (nmax + 64) / 32 * 33 + (nmax + 64) / 4 + part_floats;
}

// v of this block and of the other block of its cluster, exchanged through
// field f of xch: both get op(v of split 0, v of split 1)
__device__ __forceinline__ float cluster_max(cg::cluster_group& cl,
                                             float* xch, int f, float v) {
  if (threadIdx.x == 0) xch[f] = v;
  cl.sync();
  const float w = *cl.map_shared_rank(xch + f, cl.block_rank() ^ 1);
  return cl.block_rank() == 0 ? fmaxf(v, w) : fmaxf(w, v);
}
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cl,
                                             float* xch, int f, float v) {
  if (threadIdx.x == 0) xch[f] = v;
  cl.sync();
  const float w = *cl.map_shared_rank(xch + f, cl.block_rank() ^ 1);
  return cl.block_rank() == 0 ? v + w : w + v;
}

// q of (row b, head h) into qs; bf16: qf its bf16 rounding; int: qf the
// int8 codes (as int), returns their scale. Every thread gets the scale.
template <int MODE>
__device__ float load_q(const Args& a, const AttnSmem& m, int b, int h) {
  for (int d = threadIdx.x; d < a.dk; d += NTHREADS) {
    const float v = ldf(a.q + (size_t)b * a.I + h * a.dk + d);
    m.qs[d] = v;
    if (MODE == MODE_BF16) m.qf[d] = bfr(v);
  }
  __syncthreads();
  if (MODE == MODE_BF16) return 0.f;
  return quantize_q(m.qs, reinterpret_cast<int*>(m.qf), a.dk, m.red);
}

// One (row, head) pair's attention over `total` positions of its K/V rows
// (row d at element base + d * stride), on one block (nsplit 1) or spread
// over the two blocks of a cluster (nsplit 2): split s takes positions
// [s R, s R + R), R = total / 2 rounded up to whole 16-byte vectors. The
// splits agree through distributed shared memory on the score max m, with
// normalize (cross-attention) on the sum of exp(s - m) before p = e / sum,
// and in the int modes on max |p vs|, before p is rounded to bf16 or p vs
// requantized, so the probabilities are the one-chunk function's. Split 0
// then adds split 1's value sums (int32, exact; or f32) and lsum in split
// order: accs holds the f32 value sums (int: times the probabilities'
// scale) and m / lsum the flash state.
template <int MODE>
__device__ void attend_split(const Args& a, const AttnSmem& sm, int s,
                             int nsplit, const void* K, const void* V,
                             size_t base, int stride, int total,
                             const float* ksc, const float* vsc, float qscale,
                             bool normalize, float& m_out, float& lsum_out) {
  constexpr int EP = vec_positions<MODE>();
  cg::cluster_group cl = cg::this_cluster();
  const bool two = nsplit == 2;
  const int R = ((total + nsplit - 1) / nsplit + EP - 1) / EP * EP;
  const int p_lo = min(total, s * R), n = min(total, p_lo + R) - p_lo;
  const int C = (n + EP - 1) / EP;
  if (MODE != MODE_BF16) {      // the split's scales, while the scores load
    for (int p = threadIdx.x; p < n; p += NTHREADS) {
      const unsigned dk_ = (unsigned)__cvta_generic_to_shared(sm.ksm + p);
      const unsigned dv_ = (unsigned)__cvta_generic_to_shared(sm.vsm + p);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dk_),
                   "l"(ksc + p_lo + p));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dv_),
                   "l"(vsc + p_lo + p));
    }
    cp_async_commit();
  }
  const float lmax = fw_scores<MODE>(a, K, base + p_lo, stride, n, sm.qf,
                                     reinterpret_cast<const int*>(sm.qf),
                                     qscale, sm.ksm, sm.part, sm.sc);
  float m = block_max(lmax, sm.red);
  if (two) m = cluster_max(cl, sm.xch, 0, m);
  float ls = 0.f;
  for (int p = threadIdx.x; p < n; p += NTHREADS) {
    const float e = expf(sm.sc[sci(p)] - m);
    ls += e;
    sm.sc[sci(p)] = e;
  }
  const float lpart = block_sum(ls, sm.red);
  const float lsum = normalize && two ? cluster_sum(cl, sm.xch, 1, lpart)
                                     : lpart;
  float pm = 0.f;
  for (int p = threadIdx.x; p < C * EP; p += NTHREADS) {
    if (p >= n) {
      sm.sc[sci(p)] = 0.f;
      continue;
    }
    const float e = normalize ? sm.sc[sci(p)] / lsum : sm.sc[sci(p)];
    if (MODE == MODE_BF16) {
      sm.sc[sci(p)] = bfr(e);
    } else {
      const float pv = e * sm.vsm[p];
      sm.sc[sci(p)] = pv;
      pm = fmaxf(pm, fabsf(pv));
    }
  }
  float pscale = 0.f;
  if (MODE != MODE_BF16) {
    float pmax = block_max(pm, sm.red);
    if (two) pmax = cluster_max(cl, sm.xch, 2, pmax);
    pscale = fmaxf(pmax, 1e-20f) / 127.f;
    for (int p = threadIdx.x; p < C * EP; p += NTHREADS)
      sm.pc[code_slot<MODE>(p)] =
          p < n ? (int8_t)quant(sm.sc[sci(p)], pscale, 127.f) : 0;
  }
  __syncthreads();
  fw_values<MODE>(a, V, base + p_lo, stride, n, sm.sc, sm.pc, sm.accs,
                  sm.acci);
  __syncthreads();
  if (!two) {
    if (MODE != MODE_BF16)
      for (int d = threadIdx.x; d < a.dk; d += NTHREADS)
        sm.accs[d] = (float)sm.acci[d] * pscale;
    lsum_out = lsum;
    m_out = m;
    __syncthreads();
    return;
  }
  if (s == 1) {
    for (int d = threadIdx.x; d < a.dk; d += NTHREADS)
      sm.xch[4 + d] = MODE == MODE_BF16 ? sm.accs[d]
                                        : __int_as_float(sm.acci[d]);
    if (threadIdx.x == 0) sm.xch[3] = lpart;
  }
  cl.sync();
  if (s == 0) {
    const float* peer = cl.map_shared_rank(sm.xch, 1);
    for (int d = threadIdx.x; d < a.dk; d += NTHREADS)
      sm.accs[d] = MODE == MODE_BF16
                       ? sm.accs[d] + peer[4 + d]
                       : (float)(sm.acci[d] + __float_as_int(peer[4 + d])) *
                             pscale;
    lsum_out = normalize ? lsum : lpart + peer[3];
    m_out = m;
  }
  __syncthreads();
}

// The value sum of element e (position p) of a 16-byte V vector, as
// value_vec takes it, for a vector that straddles two chunks.
template <int MODE>
__device__ __forceinline__ void value_pos(const uint4 v, int e, int p,
                                          const float* pf, const int8_t* pc,
                                          float& accf, int& acci) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if (MODE == MODE_BF16) {
    const uint32_t w = u[e >> 1];
    accf = fmaf(pf[sci(p)],
                __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16)),
                accf);
  } else if (MODE == MODE_INT8) {
    acci += (int)pc[p] * (int)(int8_t)(u[e >> 2] >> (8 * (e & 3)));
  } else {
    acci += (int)pc[code_slot<MODE>(p)] *
            ((int)(u[e >> 3] << (28 - 4 * (e & 7))) >> 28);
  }
}

// Value sums over n positions of a (row, head)'s V rows in chunks of
// `chunk` positions (ncl of them, at most MAXC), as fw_values lays them out,
// each chunk's sum kept apart: out[d] = sum over chunks c of vals_c[d] *
// cw[c], vals_c the f32 sum of pf * v (bf16) or the int32 sum of the codes
// pc times v times psc[c] (int), in chunk order.
template <int MODE>
__device__ void fw_values_chunked(const Args& a, const void* V, size_t base,
                                  int stride, int n, int chunk, int ncl,
                                  const float* pf, const int8_t* pc,
                                  const float* psc, const float* cw,
                                  const uint8_t* vrows, float* out) {
  constexpr int EP = vec_positions<MODE>();
  constexpr bool F = MODE == MODE_BF16;
  const int dk = a.dk, C = (n + EP - 1) / EP;
  int dkp = 8;
  while (dkp < dk) dkp <<= 1;
  const int TPD = NTHREADS / dkp;               // a power of two <= 32
  const int d = threadIdx.x / TPD, j = threadIdx.x % TPD;
  float accf[MAXC];
  int acci[MAXC];
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    accf[q] = 0.f;
    acci[q] = 0;
  }
  // vector c's sums into its chunk's accumulators
  auto add = [&](const uint4 v, int c) {
    const int p0 = c * EP, qa = p0 / chunk;
    const int qb = (min(p0 + EP, n) - 1) / chunk;
    float f = 0.f;
    int i = 0;
    if (qa == qb) {
      value_vec<MODE>(v, c, pf, pc, f, i);
#pragma unroll
      for (int q = 0; q < MAXC; ++q)
        if (q == qa) {
          if (F) accf[q] += f;
          else acci[q] += i;
        }
      return;
    }
    for (int e = 0; e < EP && p0 + e < n; ++e) {
      f = 0.f;
      i = 0;
      value_pos<MODE>(v, e, p0 + e, pf, pc, f, i);
      const int qe = (p0 + e) / chunk;
#pragma unroll
      for (int q = 0; q < MAXC; ++q)
        if (q == qe) {
          if (F) accf[q] += f;
          else acci[q] += i;
        }
    }
  };
  if (d < dk && vrows != nullptr) {     // the rows staged in shared memory
    for (int c = j; c < C; c += TPD)
      add(*reinterpret_cast<const uint4*>(vrows + ((size_t)d * C + c) * 16),
          c);
  } else if (d < dk) {
    const size_t row = base + (size_t)d * stride;
    const bool aligned = rows_aligned<MODE>(V, base, stride);
    const int full = n / EP;                    // whole vectors
    int c = j;
    if (aligned && full > 0) {
      for (; c < full; c += VB * TPD) {
        uint4 v[VB];
#pragma unroll
        for (int u = 0; u < VB; ++u)       // every load before any use
          v[u] = *reinterpret_cast<const uint4*>(elem_ptr<MODE>(
              V, row + (size_t)min(c + u * TPD, full - 1) * EP));
#pragma unroll
        for (int u = 0; u < VB; ++u)
          if (c + u * TPD < full) add(v[u], c + u * TPD);
      }
      // the batches overshoot: step back to the first vector not taken
      c = full + ((j - full) % TPD + TPD) % TPD;
    }
    for (; c < C; c += TPD)
      add(load_vec<MODE>(V, row + (size_t)c * EP, min(EP, n - c * EP)), c);
  }
#pragma unroll
  for (int q = 0; q < MAXC; ++q)
    for (int o = TPD / 2; o > 0; o >>= 1) {
      if (F) accf[q] += __shfl_xor_sync(0xffffffffu, accf[q], o);
      else acci[q] += __shfl_xor_sync(0xffffffffu, acci[q], o);
    }
  if (j == 0 && d < dk) {
    float o = 0.f;
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (q < ncl)
        o += F ? accf[q] * cw[q] : ((float)acci[q] * psc[q]) * cw[q];
    out[d] = o;
  }
}

// One (row, head) pair's attention over its cache rows < P0 (row d at
// element base + d * stride) in the TPU kernel's flash chunks of a.chunk
// positions, on one block (nsplit 1) or on the two blocks of a cluster
// (nsplit 2: split 0 takes the first ceil(nc / 2) chunks, split 1 the
// rest). A chunk's running max is the prefix max of the chunk maxima, M_c
// = max(M_{c-1}, max_c), and each chunk's bf16 p = exp(s - M_c) or int
// codes of p vs (requantized with the chunk's own max) depend only on M_c:
// so the splits exchange only their chunk maxima (distributed shared
// memory), each attends its own chunks, and the partial sums combine as
// sum_c vals_c exp(M_c - M_last) (lsum likewise). The codes are the
// sequential flash update's; the f32 combination takes another order.
// Split 0 gets the flash state: accs (f32 value sums), m_out = M_last and
// lsum_out.
template <int MODE>
__device__ void attend_chunks(const Args& a, const AttnSmem& sm, int s,
                              int nsplit, const void* K, const void* V,
                              size_t base, int stride, int P0,
                              const float* ksc, const float* vsc,
                              float qscale, float& m_out, float& lsum_out,
                              bool stamp) {
  constexpr int EP = vec_positions<MODE>();
  cg::cluster_group cl = cg::this_cluster();
  const bool two = nsplit == 2;
  const int CH = a.chunk, nc = (P0 + CH - 1) / CH;
  ASTAMP(0)
  const int cmid = two ? (nc + 1) / 2 : nc;
  const int c_lo = s == 0 ? 0 : cmid, c_hi = s == 0 ? cmid : nc;
  const int ncl = c_hi - c_lo;
  const int p_lo = min(P0, c_lo * CH), n = min(P0, c_hi * CH) - p_lo;
  const int Cv = (n + EP - 1) / EP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the split's V rows into shared memory (16-byte cp.async, the last
  // vector of a row zero-filled past n), in flight with the K loads
  const bool vstage = n > 0 && rows_aligned<MODE>(V, base + p_lo, stride);
  if (vstage) {
    for (int i = tid; i < a.dk * Cv; i += NTHREADS) {
      const int d = i / Cv, c = i % Cv, valid = min(EP, n - c * EP);
      const int bytes = MODE == MODE_BF16   ? 2 * valid
                        : MODE == MODE_INT8 ? valid
                                            : (valid + 1) / 2;
      asm volatile(
          "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
              (unsigned)__cvta_generic_to_shared(sm.vrows + (size_t)i * 16)),
          "l"(elem_ptr<MODE>(V, base + p_lo + (size_t)d * stride +
                                    (size_t)c * EP)),
          "r"(bytes));
    }
    cp_async_commit();
  }
  if (MODE != MODE_BF16) {      // the split's scales, while the scores load
    for (int p = tid; p < n; p += NTHREADS) {
      const unsigned dk_ = (unsigned)__cvta_generic_to_shared(sm.ksm + p);
      const unsigned dv_ = (unsigned)__cvta_generic_to_shared(sm.vsm + p);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dk_),
                   "l"(ksc + p_lo + p));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dv_),
                   "l"(vsc + p_lo + p));
    }
    cp_async_commit();
  }
  if (n > 0)
    fw_scores<MODE>(a, K, base + p_lo, stride, n, sm.qf,
                    reinterpret_cast<const int*>(sm.qf), qscale, sm.ksm,
                    sm.part, sm.sc);
  __syncthreads();
  ASTAMP(1)
  // this block's chunk maxima, then every chunk's running max
  float v[MAXC];
#pragma unroll
  for (int q = 0; q < MAXC; ++q) v[q] = -INFINITY;
  for (int p = tid; p < n; p += NTHREADS) {
    const int ci = p / CH;
    const float x = sm.sc[sci(p)];
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (q == ci) v[q] = fmaxf(v[q], x);
  }
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    v[q] = warp_max(v[q]);
    if (lane == 0) sm.red2[warp * MAXC + q] = v[q];
  }
  __syncthreads();
  if (tid < ncl) {
    float x = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) x = fmaxf(x, sm.red2[w * MAXC + tid]);
    sm.cxm[tid] = x;
  }
  if (two) cl.sync();
  else __syncthreads();
  if (tid == 0) {
    const float* peer =
        two ? cl.map_shared_rank(sm.cxm, cl.block_rank() ^ 1) : nullptr;
    const int peer_lo = s == 0 ? cmid : 0;
    float run = -INFINITY;
    for (int c = 0; c < nc; ++c) {
      const float x = c >= c_lo && c < c_hi ? sm.cxm[c - c_lo]
                                             : peer[c - peer_lo];
      run = fmaxf(run, x);
      sm.gm[c] = run;
    }
  }
  __syncthreads();
  ASTAMP(2)
  // p = exp(s - M_c): bf16-rounded, or p vs for the codes; per chunk the
  // sum of p and the max |p vs|
  float ls[MAXC], pm[MAXC];
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    ls[q] = 0.f;
    pm[q] = 0.f;
  }
  for (int p = tid; p < Cv * EP; p += NTHREADS) {
    if (p >= n) {
      sm.sc[sci(p)] = 0.f;
      continue;
    }
    const int ci = p / CH;
    const float e = expf(sm.sc[sci(p)] - sm.gm[c_lo + ci]);
    float pv = 0.f;
    if (MODE == MODE_BF16) {
      sm.sc[sci(p)] = bfr(e);
    } else {
      pv = e * sm.vsm[p];
      sm.sc[sci(p)] = pv;
    }
#pragma unroll
    for (int q = 0; q < MAXC; ++q)
      if (q == ci) {
        ls[q] += e;
        pm[q] = fmaxf(pm[q], fabsf(pv));
      }
  }
#pragma unroll
  for (int q = 0; q < MAXC; ++q) {
    ls[q] = warp_sum(ls[q]);
    pm[q] = warp_max(pm[q]);
    if (lane == 0) {
      sm.red2[warp * MAXC + q] = ls[q];
      sm.red3[warp * MAXC + q] = pm[q];
    }
  }
  __syncthreads();
  if (tid < ncl) {
    float l_ = 0.f, x = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      l_ += sm.red2[w * MAXC + tid];
      x = fmaxf(x, sm.red3[w * MAXC + tid]);
    }
    sm.lsc[tid] = l_;
    sm.psc[tid] = fmaxf(x, 1e-20f) / 127.f;
    sm.cw[tid] = expf(sm.gm[c_lo + tid] - sm.gm[nc - 1]);
  }
  __syncthreads();
  ASTAMP(3)
  if (MODE != MODE_BF16) {
    for (int p = tid; p < Cv * EP; p += NTHREADS)
      sm.pc[code_slot<MODE>(p)] =
          p < n ? (int8_t)quant(sm.sc[sci(p)], sm.psc[p / CH], 127.f) : 0;
    __syncthreads();
  }
  if (vstage) {
    cp_async_wait_all();
    __syncthreads();
  }
  ASTAMP(4)
  fw_values_chunked<MODE>(a, V, base + p_lo, stride, n, CH, ncl, sm.sc,
                          sm.pc, sm.psc, sm.cw,
                          vstage ? sm.vrows : nullptr, sm.accs);
  __syncthreads();
  ASTAMP(5)
  float lpart = 0.f;
  for (int q = 0; q < ncl; ++q) lpart += sm.lsc[q] * sm.cw[q];
  const float m_last = sm.gm[nc - 1];
  if (!two) {
    lsum_out = lpart;
    m_out = m_last;
    ASTAMP(6)
    return;
  }
  if (s == 1) {
    for (int d = tid; d < a.dk; d += NTHREADS) sm.xch[4 + d] = sm.accs[d];
    if (tid == 0) sm.xch[3] = lpart;
  }
  cl.sync();
  if (s == 0) {
    const float* peer = cl.map_shared_rank(sm.xch, 1);
    for (int d = tid; d < a.dk; d += NTHREADS) sm.accs[d] += peer[4 + d];
    lsum_out = lpart + peer[3];
    m_out = m_last;
  }
  __syncthreads();
  ASTAMP(6)
}

// Self-attention of layer l, step t: while every (row, head) pair can have
// a cluster of two blocks (2 H B <= the grid), each pair's cache rows < pos0
// are split between the two: the window's as one flash chunk
// (attend_split), the step's and the grouped window's in the TPU kernel's
// chunks (attend_chunks); past that (B > 11 at 6 heads) the blocks loop
// over whole pairs, which already fill the card. Then split 0 attends the
// window's rows 0..t in window order, an online softmax in f32, or the
// step's own row as an f32 diagonal term on the unrounded q, k and v.
template <int MODE, int KIND>
__device__ void fw_self_attn(const Args& a, float* un, int nmax, int t,
                             int l) {
  const AttnSmem sm =
      attn_smem(un, nmax, vrow_floats<MODE, KIND>(a, gridDim.x));
  const int HB = a.H * a.B, dk = a.dk, P0 = a.pos0;
  const int nsplit = 2 * HB <= (int)gridDim.x ? 2 : 1;
  const int s = blockIdx.x % nsplit, stride = gridDim.x / nsplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the chunked kinds' spare blocks (past the pairs' clusters) emit the
  // int modes' rows, off the attending blocks' path
  const bool spare_emit = KIND != KIND_WINDOW && nsplit == 2 &&
                          2 * HB < (int)gridDim.x;
  if (MODE != MODE_BF16 && spare_emit && (int)blockIdx.x >= 2 * HB)
    for (int pair = blockIdx.x - 2 * HB; pair < HB;
         pair += gridDim.x - 2 * HB) {
      __syncthreads();
      emit_rows<KIND>(a, sm.red, t, l, pair / a.B, pair % a.B);
    }
  for (int pair = blockIdx.x / nsplit; pair < HB; pair += stride) {
    const int h = pair / a.B, b = pair % a.B;   // pair == h * B + b
    const bool stamp = KIND == KIND_STEP && blockIdx.x == 0 && l == 0 &&
                       pair == 0;
    __syncthreads();
    if (KIND == KIND_STEP && s == 0)   // in flight meanwhile
      for (int d = threadIdx.x; d < 2 * dk; d += NTHREADS)
        sm.kvd[d] = ldf(a.kvf + (size_t)b * 2 * a.I + (d < dk ? 0 : a.I) +
                        h * dk + d % dk);
    const float qscale = load_q<MODE>(a, sm, b, h);
    if (MODE != MODE_BF16 && s == nsplit - 1 && !spare_emit)
      emit_rows<KIND>(a, sm.red, t, l, h, b);
    float m = -1e30f, lsum = 0.f;
    if (P0 > 0) {
      const size_t pr = pair_index<KIND>(a, l, h, b);
      if (KIND == KIND_WINDOW)
        attend_split<MODE>(a, sm, s, nsplit, a.kc, a.vc, pr * dk * a.P, a.P,
                           P0, a.ks + pr * a.P, a.vs + pr * a.P, qscale,
                           false, m, lsum);
      else
        attend_chunks<MODE>(a, sm, s, nsplit, a.kc, a.vc, pr * dk * a.P,
                            a.P, P0, a.ks + pr * a.P, a.vs + pr * a.P,
                            qscale, m, lsum, stamp);
    }
    if (s != 0) continue;
    if (KIND == KIND_STEP) {
      if (warp == 0) {               // the diagonal term, f32
        float acc[MAX_DK / 32], vj[MAX_DK / 32], sv = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_DK / 32; ++i) {
          const int d = lane + 32 * i;
          acc[i] = (P0 > 0 && d < dk) ? sm.accs[d] : 0.f;
          const float kd = d < dk ? sm.kvd[d] : 0.f;
          vj[i] = d < dk ? sm.kvd[dk + d] : 0.f;
          sv = fmaf(d < dk ? sm.qs[d] : 0.f, kd, sv);
        }
        sv = warp_sum(sv);
        const float m_new = fmaxf(m, sv);
        const float alpha = expf(m - m_new);
        const float p = expf(sv - m_new);
        lsum = lsum * alpha + p;
#pragma unroll
        for (int i = 0; i < MAX_DK / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < dk)
            a.attn[(size_t)b * a.I + h * dk + d] =
                f2bf((acc[i] * alpha + p * vj[i]) / lsum);
        }
      }
      ASTAMP(7)
      continue;
    }
    if (s != 0) continue;
    // split 0: the window's rows 0..t, an online softmax in window order
    float* kwin = sm.part;                      // [t + 1][dk] f32
    float* vwin = kwin + (t + 1) * dk;
    float* sj = vwin + (t + 1) * dk;            // [t + 1] scores
    const size_t jstride = (size_t)a.L * HB * dk;
    const size_t row = ((size_t)l * HB + pair) * dk;
    for (int i0 = threadIdx.x; i0 < (t + 1) * dk; i0 += 4 * NTHREADS) {
      float kv[4], vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {        // every load before any use
        const int i = min(i0 + u * NTHREADS, (t + 1) * dk - 1);
        const size_t off = (i / dk) * jstride + row + i % dk;
        kv[u] = ldb(a.kw + off);
        vv[u] = ldb(a.vw + off);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NTHREADS;
        if (i < (t + 1) * dk) {
          kwin[i] = kv[u];
          vwin[i] = vv[u];
        }
      }
    }
    __syncthreads();
    for (int j = warp; j <= t; j += NWARPS) {
      float sv = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_DK / 32; ++i) {
        const int d = lane + 32 * i;
        sv = fmaf(d < dk ? sm.qs[d] : 0.f, d < dk ? kwin[j * dk + d] : 0.f,
                  sv);
      }
      sv = warp_sum(sv);
      if (lane == 0) sj[j] = sv;
    }
    __syncthreads();
    if (warp == 0) {
      float acc[MAX_DK / 32];
#pragma unroll
      for (int i = 0; i < MAX_DK / 32; ++i) {
        const int d = lane + 32 * i;
        acc[i] = (P0 > 0 && d < dk) ? sm.accs[d] : 0.f;
      }
      for (int j = 0; j <= t; ++j) {
        const float sv = sj[j];
        const float m_new = fmaxf(m, sv);
        const float alpha = expf(m - m_new);
        const float p = expf(sv - m_new);
        lsum = lsum * alpha + p;
#pragma unroll
        for (int i = 0; i < MAX_DK / 32; ++i) {
          const int d = lane + 32 * i;
          acc[i] = acc[i] * alpha + p * (d < dk ? vwin[j * dk + d] : 0.f);
        }
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

// Cross-attention of layer l over the encoder K/V: a full f32 softmax, one
// block a pair (attend_split, normalized). Its 256-320 rows are too few to
// pay for a split's exchanges.
template <int MODE, int KIND>
__device__ void fw_cross_attn(const Args& a, float* un, int nmax, int l) {
  const AttnSmem sm =
      attn_smem(un, nmax, vrow_floats<MODE, KIND>(a, gridDim.x));
  const int HB = a.H * a.B, dk = a.dk, S = a.Lenc;
  for (int pair = blockIdx.x; pair < HB; pair += gridDim.x) {
    const int h = pair / a.B, b = pair % a.B;
    __syncthreads();
    const float qscale = load_q<MODE>(a, sm, b, h);
    const size_t pr = pair_index<KIND>(a, l, h, b);
    float m = 0.f, lsum = 0.f;
    attend_split<MODE>(a, sm, 0, 1, a.ck, a.cv, pr * dk * S, S, S,
                       a.cks + pr * S, a.cvs + pr * S, qscale, true, m, lsum);
    for (int d = threadIdx.x; d < dk; d += NTHREADS)
      a.attn[(size_t)b * a.I + h * dk + d] = f2bf(sm.accs[d]);
  }
}

// the projection after m of layer l (step t): (m', l', t'), false past the
// window's last lm_head
__device__ __forceinline__ bool next_projection(const Args& a, int& m, int& l,
                                                int& t) {
  if (m == PR_LM) {
    m = PR_QKV;
    l = 0;
    return ++t < a.T;
  }
  if (m == PR_FFOUT) {
    if (++l == a.L) {
      m = PR_LM;
      l = 0;
    } else {
      m = PR_QKV;
    }
    return true;
  }
  ++m;
  return true;
}

// Projection m of layer l by fd_kernel's 32-column x 8-row tiles over every
// block (matvec_phase), its weights read straight from L2: the step and the
// grouped window above 8 rows.
template <int MODE, int KIND>
__device__ void tile_project(const Args& a, int m, int l, int t,
                             float* smem) {
  const int I = a.I, D = a.D, F = a.F;
  const bool q = MODE != MODE_BF16;
  const float* nw = a.norms + (size_t)l * 3 * D;
  switch (m) {
    case PR_QKV:
      matvec_phase<MODE, KIND>(a, smem, D, 3 * I, a.wqkv,
                               (size_t)l * D * 3 * I,
                               q ? a.sqkv + (size_t)l * 3 * I : nullptr,
                               IN_RMS, nw, nullptr, OUT_QKV, nullptr, t, l);
      break;
    case PR_WO:
      matvec_phase<MODE, KIND>(a, smem, I, D, a.wo, (size_t)l * I * D,
                               q ? a.so + (size_t)l * D : nullptr, IN_BF16,
                               nullptr, a.attn, OUT_RESID, nullptr, t, l);
      break;
    case PR_WQC:
      matvec_phase<MODE, KIND>(a, smem, D, I, a.wqc, (size_t)l * D * I,
                               q ? a.sqc + (size_t)l * I : nullptr, IN_RMS,
                               nw + D, nullptr, OUT_STORE, a.q, t, l);
      break;
    case PR_WOC:
      matvec_phase<MODE, KIND>(a, smem, I, D, a.woc, (size_t)l * I * D,
                               q ? a.soc + (size_t)l * D : nullptr, IN_BF16,
                               nullptr, a.attn, OUT_RESID, nullptr, t, l);
      break;
    case PR_FFIN:
      matvec_phase<MODE, KIND>(a, smem, D, 2 * F, a.wff_in,
                               (size_t)l * D * 2 * F,
                               q ? a.sff_in + (size_t)l * 2 * F : nullptr,
                               IN_RMS, nw + 2 * D, nullptr, OUT_STORE, a.g,
                               t, l);
      break;
    case PR_FFOUT:
      matvec_phase<MODE, KIND>(a, smem, F, D, a.wff_out, (size_t)l * F * D,
                               q ? a.sff_out + (size_t)l * D : nullptr,
                               IN_GATED, nullptr, nullptr, OUT_RESID,
                               nullptr, t, l);
      break;
    default:
      matvec_phase<MODE, KIND>(a, smem, D, a.V, a.lm, 0, q ? a.lm_s : nullptr,
                               IN_RMS, a.final_norm, nullptr, OUT_STORE,
                               a.logits, t, 0);
  }
}

// The window (KIND_WINDOW), the grouped window (KIND_GROUPED) and the step
// (KIND_STEP: one step from the given x, ending at the logits): one
// persistent launch, the phases between grid barriers. The parameters are
// grid constants: functions that take them by reference read them in
// place.
template <int MODE, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1)
    fw_kernel(const __grid_constant__ Args a, int nmax, int hcap) {
  extern __shared__ float4 smem4[];
  uint8_t* wreg = reinterpret_cast<uint8_t*>(smem4);
  float* normsm = reinterpret_cast<float*>(wreg + a.wbytes);
  const int nnorm = (3 * a.L + 1) * a.D;
  float* un = normsm + (nnorm + 3) / 4 * 4;
  constexpr bool RESIDENT = MODE == MODE_INT4;
  const int G = gridDim.x, blk = blockIdx.x;
  const int half = a.wbytes / 2;
  unsigned epoch = 0;
  int ord = 0;                                  // streamed projections
#ifdef PHASE_TRACE
  if (blockIdx.x == 0 && threadIdx.x == 0) g_phase_ns[0] = global_ns();
#endif
  if (RESIDENT) {
    for (int l = 0; l < a.L; ++l)
      for (int m = PR_QKV; m < PR_LM; ++m)
        copy_slice<MODE, false>(
            a, m, l, wreg + resident_offset<MODE>(a, m, l, blk, G));
    copy_slice<MODE, false>(
        a, PR_LM, 0, wreg + resident_offset<MODE>(a, PR_LM, 0, blk, G));
  } else {
    copy_slice<MODE, true>(a, PR_QKV, 0, wreg);
    cp_async_commit();
  }
  // every RMS norm's weights, read by every block in every RMS phase:
  // 16-byte cp.async, waited for with the first weights
  for (int i = 4 * threadIdx.x; i < nnorm; i += 4 * NTHREADS) {
    const float* src = i < 3 * a.L * a.D ? a.norms + i
                                         : a.final_norm + (i - 3 * a.L * a.D);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(normsm + i)),
                 "l"(src));
  }
  cp_async_commit();
  if (RESIDENT) {                               // project does not wait
    cp_async_wait_all();
    __syncthreads();
  }
  if (KIND != KIND_STEP) {                      // the step's x arrives filled
    init_phase(a);
    grid_barrier(a, epoch);
  }
  // the weights of projection m, layer l; streamed: wait for its copy and
  // start the next projection's into the other buffer
  auto project = [&](int m, int l, int t) {
    const uint8_t* w;
    if (RESIDENT) {
      w = wreg + resident_offset<MODE>(a, m, l, blk, G);
    } else {
      cp_async_wait_all();
      __syncthreads();
      w = wreg + (ord & 1) * half;
      int m2 = m, l2 = l, t2 = t;
      if (next_projection(a, m2, l2, t2))
        copy_slice<MODE, true>(a, m2, l2, wreg + ((ord + 1) & 1) * half);
      cp_async_commit();
      ++ord;
    }
    fw_project<MODE, KIND>(a, m, l, t, w, normsm, un, hcap);
  };
  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < a.L; ++l) {
      project(PR_QKV, l, t);
      grid_barrier(a, epoch);
      fw_self_attn<MODE, KIND>(a, un, nmax, t, l);
      grid_barrier(a, epoch);
      project(PR_WO, l, t);
      grid_barrier(a, epoch);
      project(PR_WQC, l, t);
      grid_barrier(a, epoch);
      fw_cross_attn<MODE, KIND>(a, un, nmax, l);
      grid_barrier(a, epoch);
      project(PR_WOC, l, t);
      grid_barrier(a, epoch);
      project(PR_FFIN, l, t);
      grid_barrier(a, epoch);
      project(PR_FFOUT, l, t);
      grid_barrier(a, epoch);
    }
    project(PR_LM, 0, t);
#ifdef PHASE_TRACE
    if (KIND == KIND_STEP && blockIdx.x == 0 && threadIdx.x == 0)
      g_phase_ns[epoch + 1] = global_ns();   // block 0's own end
#endif
    if (KIND == KIND_STEP) break;               // the logits are the output
    grid_barrier(a, epoch);
    argmax_phase(a, un, t);
    if (t + 1 < a.T) grid_barrier(a, epoch);
  }
}

// The step and the grouped window above 8 rows: fd_kernel's 32-column x
// 8-row tiles for the projections (tile_project; teams of blocks, one an
// 8-row group, and fw_kernel's layout staging all the rows in every block
// both measured slower there, PERF.md), this header's chunked attention
// and grid barrier. A kernel of its own, so that fw_kernel's projection
// code does not set its registers (the same tiles inside fw_kernel ran
// ~20% slower).
template <int MODE, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1)
    ft_kernel(const __grid_constant__ Args a, int nmax) {
  extern __shared__ float4 smem4[];
  float* un = reinterpret_cast<float*>(smem4);
  unsigned epoch = 0;
#ifdef PHASE_TRACE
  if (blockIdx.x == 0 && threadIdx.x == 0) g_phase_ns[0] = global_ns();
#endif
  if (KIND != KIND_STEP) {
    init_phase(a);
    grid_barrier(a, epoch);
  }
  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < a.L; ++l) {
      tile_project<MODE, KIND>(a, PR_QKV, l, t, un);
      grid_barrier(a, epoch);
      fw_self_attn<MODE, KIND>(a, un, nmax, t, l);
      grid_barrier(a, epoch);
      tile_project<MODE, KIND>(a, PR_WO, l, t, un);
      grid_barrier(a, epoch);
      tile_project<MODE, KIND>(a, PR_WQC, l, t, un);
      grid_barrier(a, epoch);
      fw_cross_attn<MODE, KIND>(a, un, nmax, l);
      grid_barrier(a, epoch);
      tile_project<MODE, KIND>(a, PR_WOC, l, t, un);
      grid_barrier(a, epoch);
      tile_project<MODE, KIND>(a, PR_FFIN, l, t, un);
      grid_barrier(a, epoch);
      tile_project<MODE, KIND>(a, PR_FFOUT, l, t, un);
      grid_barrier(a, epoch);
    }
    tile_project<MODE, KIND>(a, PR_LM, 0, t, un);
#ifdef PHASE_TRACE
    if (KIND == KIND_STEP && blockIdx.x == 0 && threadIdx.x == 0)
      g_phase_ns[epoch + 1] = global_ns();   // block 0's own end
#endif
    if (KIND == KIND_STEP) break;
    grid_barrier(a, epoch);
    argmax_phase(a, un, t);
    if (t + 1 < a.T) grid_barrier(a, epoch);
  }
}

// a launch of clusters of two over the card's SMs, cooperative (all
// resident for the spin barrier)
template <typename... P, typename... A>
static int launch_clusters(void (*kernel)(P...), int G, size_t smem,
                           cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < G / 2) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// the attention's positions a block holds at most (nmax) on a grid of G:
// the cache rows a split attends, or the encoder rows (-1 past MAXC
// chunks)
template <int MODE, int KIND>
static int attention_positions(const Args& a, int G) {
  constexpr int EP = vec_positions<MODE>();
  const int r_self = self_positions<MODE, KIND>(a, G);
  const int r_cross = (a.Lenc + EP - 1) / EP * EP;
  return r_self < 0 ? -1 : r_self > r_cross ? r_self : r_cross;
}

// the attention's floats of shared memory for nmax positions on a grid of
// G, the chunked kinds' V rows included
template <int MODE, int KIND>
static int attention_floats(const Args& a, int nmax, int G) {
  constexpr int EP = vec_positions<MODE>();
  int part_floats = NTHREADS * EP;
  if (nmax + EP > part_floats) part_floats = nmax + EP;
  if (2 * a.T * a.dk + a.T > part_floats) part_floats = 2 * a.T * a.dk + a.T;
  return attn_floats(nmax, part_floats) + vrow_floats<MODE, KIND>(a, G);
}

// Launch ft_kernel (checked by launch_window). External, like
// launch_window, so that a source can leave an instantiation to another
// translation unit of its library (extern template; cuda_build.PARTS).
template <int MODE, int KIND>
int launch_tiles(Args a, int G, cudaStream_t stream) {
  const int nmax = attention_positions<MODE, KIND>(a, G);
  if (nmax < 0) return (int)cudaErrorInvalidValue;
  int kmax = a.D > a.I ? a.D : a.I;
  if (a.F > kmax) kmax = a.F;
  int un = attention_floats<MODE, KIND>(a, nmax, G);
  if (ROWS * kmax + NWARPS * ROWS * TILE_N > un)
    un = ROWS * kmax + NWARPS * ROWS * TILE_N;
  if (3 * NWARPS + 1 > un) un = 3 * NWARPS + 1;
  return launch_clusters(ft_kernel<MODE, KIND>, G, (size_t)un * sizeof(float),
                         stream, a, nmax);
}

// Launch fw_kernel: one block of NTHREADS per SM in clusters of two (a
// cooperative launch, so all are resident for the spin barrier), weights
// resident (int4) or two streamed slices (bf16, int8); the step and the
// grouped window above 8 rows read theirs from L2 in fd_kernel's tiles.
// Returns a CUDA error code; invalid value for a projection with more than
// MAX_SUB sub-units a block, d_kv above MAX_DK, widths not multiples of 8,
// no sync buffer, a chunk below 1, or (the step and the grouped window) a
// block with more than MAXC cache chunks.
template <int MODE, int KIND>
int launch_window(Args a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int G = sms / 2 * 2;                    // whole clusters of two
  if (G < 2 || a.dk > MAX_DK || a.D > MAX_D || a.sync == nullptr ||
      a.D % 8 || a.I % 8 || a.F % 8 || a.V % 8 || a.chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (KIND != KIND_WINDOW && a.B > ROWS)
    return launch_tiles<MODE, KIND>(a, G, stream);
  size_t resident = 0, stream_slice = 0;
  int kmax = 0;
  for (int m = PR_QKV; m <= PR_LM; ++m) {
    const ProjShape s = proj_shape(a, m);
    const int nsub = proj_subunits(s, 0, G);
    if (nsub > MAX_SUB) return (int)cudaErrorInvalidValue;
    const size_t sz = slice_bytes<MODE>(s, nsub);
    resident += m == PR_LM ? sz : (size_t)a.L * sz;
    if (sz > stream_slice) stream_slice = sz;
    if (s.K > kmax) kmax = s.K;
  }
  a.wbytes = (int)(MODE == MODE_INT4 ? resident : 2 * stream_slice);
  const int bpad = h_stride((a.B + ROWS - 1) / ROWS * ROWS);
  int hcap = bpad * kmax;
  if (hcap > HCAP) hcap = HCAP / bpad / 8 * 8 * bpad;
  const int nmax = attention_positions<MODE, KIND>(a, G);
  if (nmax < 0) return (int)cudaErrorInvalidValue;
  const int mv_floats = hcap / 2 + NWARPS * 4 * ROWS * UNIT + bpad;
  int un = attention_floats<MODE, KIND>(a, nmax, G);
  if (mv_floats > un) un = mv_floats;
  if (3 * NWARPS + 1 > un) un = 3 * NWARPS + 1;
  const int norm_floats = ((3 * a.L + 1) * a.D + 3) / 4 * 4;
  const size_t smem =
      (size_t)a.wbytes + (size_t)(norm_floats + un) * sizeof(float);
  return launch_clusters(fw_kernel<MODE, KIND>, G, smem, stream, a, nmax,
                         hcap);
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
  P_TOK, P_FIN, P_KVF, P_SYNC, P_COUNT
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
  a.sync = (unsigned*)p[P_SYNC];
  a.wbytes = 0;

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
