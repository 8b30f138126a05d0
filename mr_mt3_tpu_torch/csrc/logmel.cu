// Fused log-mel spectrogram for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mr_mt3_tpu/ops/mel_pallas.py::logmel_pallas
// (pallas_call :137, _kernel :68). Per segment b and frame f, as the TPU
// kernel computes it:
//   1. frame f is window samples x[f * 128 + t], t < 2048, zero past the
//      segment's n samples (pad_end framing);
//   2. re[f, k] = sum_t x * cos_m[t, k], im[f, k] = sum_t x * sin_m[t, k],
//      where cos_m and sin_m (2048, ld) hold cos and -sin of 2 pi t k / 2048
//      times the periodic Hann window (ops/mel_kernel.py::_dft_constants);
//   3. mag = sqrt(re^2 + im^2);
//   4. mel[f, m] = sum_k mag[f, k] fbank[k, m];
//   5. out = log(mel <= 0 ? eps : mel).
// Everything in f32 FMAs on the CUDA cores: no TF32, no bf16 (a DFT in
// reduced precision is far too lossy, which is why the TPU kernel asks
// for Precision.HIGHEST). The (frames, bins) spectrum never leaves the
// block. Built without --use_fast_math, so sqrtf and logf are the IEEE
// ones.
//
// Layout: x (B, n) f32; cos_m, sin_m (2048, ld) and fbank (ld, mel) f32,
// the bin axis padded with zeros to ld (a multiple of 32); out (B, frames,
// mel) f32 with frames = ceil(n / 128). Only the first `bins` (1025) bins
// are computed.
//
// Bound on the H100 (67 TFLOP/s f32 on the CUDA cores; 3.35 TB/s HBM): per
// segment of 256 frames 2 x 256 x 2048 x 1025 x 2 + 2 x 256 x 1025 x 512
// ~ 2.42 GFLOP against ~0.5 MB of audio and 21 MB of constants read once:
// bound by operations, ~0.29 ms at B = 8. chip_smoke.py computes the bound
// of each case. (An FFT does ~1/60 of the DFT's work; the products are the
// TPU kernel's arithmetic, checkable against a float64 DFT term by term.)
//
// Design (right and simple first). The TPU grid's bin-tile axis carried
// the mel sum in VMEM scratch from step to step; here one block owns a
// tile of FT = 16 frames of one segment (grid: frame tiles x segments, so
// B = 8 gives 128 blocks) and loops over the bins in tiles of KT = 256,
// the mel partial sums in registers (2 mel columns x 16 frames a thread).
// The audio under the frame tile is staged once in shared memory as hop
// blocks of 128 samples (rows padded to 132 floats, so four frames' rows
// fall in distinct banks): frame f's samples [j * 128, (j + 1) * 128) are
// hop block f + j, the shifted slices of mel_pallas.py:77-91, no gather.
// The DFT constants stream through a two-stage cp.async ring, TT = 16 rows
// of KT columns of cos and sin a stage. Each thread owns 4 frames x 4 bins
// and forms the products from float4 loads (4 samples of each frame, 4
// bins of each constant): 128 FMAs per 12 shared loads. Each 16-sample
// stage sums into fresh partials that are then added to the running sums
// (two-level summation, so the rounding error of a 2048-term sum stays
// near that of a blocked product). After a bin tile the magnitudes go to
// shared memory and every thread adds its mel columns' products. A warp
// whose 32 bins all lie past `bins` skips the products (the last tile holds
// only the Nyquist bin). Not done yet: an FFT in shared memory (a later
// redesign), tensor cores in a split-f32 form, more frames per block at
// large B to read the constants fewer times from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HOP 128                  // hop width (samples)
#define FFT 2048                 // window (samples)
#define NTHREADS 256
#define FT 16                    // frames a block
#define KT 256                   // bins a tile
#define TT 16                    // window samples a pipeline stage
#define CPT (FFT / TT)           // stages a bin tile
#define ROW (HOP + 4)            // padded hop-block row in shared memory
#define NBLK (FT + FFT / HOP - 1)  // hop blocks under a tile of frames
#define MAX_MEL 512
#define MEL_PER_THREAD (MAX_MEL / NTHREADS)

struct Args {
  const float* x;
  const float* cosm;
  const float* sinm;
  const float* fbank;
  float* out;
  int B, n, frames, bins, ld, mel;
  int lim;       // constant columns worth copying: bins rounded up to 32
  float eps;
};

constexpr size_t SMEM_FLOATS =
    (size_t)NBLK * ROW + 2 * 2 * TT * KT + (size_t)KT * FT;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Copy stage g (bin tile g / CPT, window rows (g % CPT) * TT ...) of cos_m
// and sin_m into cs / sn (TT x KT each).
__device__ __forceinline__ void load_stage(const Args& a, float* cs,
                                           float* sn, int g, int tid) {
  const int col0 = (g / CPT) * KT, t0 = (g % CPT) * TT;
  for (int i = tid; i < TT * KT / 4; i += NTHREADS) {
    const int r = i / (KT / 4), q = (i % (KT / 4)) * 4;
    if (col0 + q < a.lim) {
      const size_t off = (size_t)(t0 + r) * a.ld + col0 + q;
      cp_async16(cs + r * KT + q, a.cosm + off);
      cp_async16(sn + r * KT + q, a.sinm + off);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) logmel_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* blk = reinterpret_cast<float*>(smem4);   // [NBLK][ROW]
  float* cs = blk + NBLK * ROW;                    // [2][TT][KT]
  float* sn = cs + 2 * TT * KT;                    // [2][TT][KT]
  float* mag = sn + 2 * TT * KT;                   // [KT][FT]

  const int tid = threadIdx.x, warp = tid / 32;
  const int tf = tid % 4, tk = tid / 4;   // frames tf + 4i, bins 4 tk + v
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const int nchunks = (a.bins + KT - 1) / KT * CPT;

  load_stage(a, cs, sn, 0, tid);
  cp_async_commit();
  // the hop blocks under this tile of frames, zero past the segment's end
  const float* x = a.x + (size_t)b * a.n;
  for (int i = tid; i < NBLK * HOP; i += NTHREADS) {
    const int r = i / HOP, s = i % HOP;
    const long idx = (long)(f0 + r) * HOP + s;
    blk[r * ROW + s] = idx < a.n ? x[idx] : 0.f;
  }

  float mel[MEL_PER_THREAD][FT];   // mel columns tid + NTHREADS c
#pragma unroll
  for (int c = 0; c < MEL_PER_THREAD; ++c)
#pragma unroll
    for (int f = 0; f < FT; ++f) mel[c][f] = 0.f;
  float re[4][4], im[4][4];

  for (int g = 0; g < nchunks; ++g) {
    const int tile = g / CPT, c = g % CPT;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) re[i][v] = im[i][v] = 0.f;
    }
    if (g + 1 < nchunks)
      load_stage(a, cs + ((g + 1) & 1) * TT * KT,
                 sn + ((g + 1) & 1) * TT * KT, g + 1, tid);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    // warp-uniform: a warp's 32 bins all past `bins` have no products
    const bool active = tile * KT + 32 * warp < a.bins;
    if (active) {
      const float* cst = cs + (g & 1) * TT * KT + 4 * tk;
      const float* snt = sn + (g & 1) * TT * KT + 4 * tk;
      const int t0 = c * TT, j = t0 / HOP, s0 = t0 % HOP;
      float pr[4][4], pi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) pr[i][v] = pi[i][v] = 0.f;
#pragma unroll
      for (int tt = 0; tt < TT; tt += 4) {
        float4 xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = *reinterpret_cast<const float4*>(
              blk + (tf + 4 * i + j) * ROW + s0 + tt);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 cv =
              *reinterpret_cast<const float4*>(cst + (tt + u) * KT);
          const float4 sv =
              *reinterpret_cast<const float4*>(snt + (tt + u) * KT);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xs = lane(xv[i], u);
            pr[i][0] = fmaf(xs, cv.x, pr[i][0]);
            pr[i][1] = fmaf(xs, cv.y, pr[i][1]);
            pr[i][2] = fmaf(xs, cv.z, pr[i][2]);
            pr[i][3] = fmaf(xs, cv.w, pr[i][3]);
            pi[i][0] = fmaf(xs, sv.x, pi[i][0]);
            pi[i][1] = fmaf(xs, sv.y, pi[i][1]);
            pi[i][2] = fmaf(xs, sv.z, pi[i][2]);
            pi[i][3] = fmaf(xs, sv.w, pi[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          re[i][v] += pr[i][v];
          im[i][v] += pi[i][v];
        }
    }
    __syncthreads();   // this stage's buffer takes the copy issued next
    if (c == CPT - 1) {
      // the tile's bins are summed: magnitudes, then the mel products
      if (active) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            mag[(4 * tk + v) * FT + tf + 4 * i] =
                sqrtf(re[i][v] * re[i][v] + im[i][v] * im[i][v]);
      }
      __syncthreads();
      const int nk = min(KT, a.bins - tile * KT);
      const float* fb = a.fbank + (size_t)tile * KT * a.mel;
      for (int k = 0; k < nk; ++k) {
        float mk[FT];
#pragma unroll
        for (int q = 0; q < FT / 4; ++q) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(mag + k * FT + 4 * q);
          mk[4 * q] = v4.x;
          mk[4 * q + 1] = v4.y;
          mk[4 * q + 2] = v4.z;
          mk[4 * q + 3] = v4.w;
        }
#pragma unroll
        for (int cc = 0; cc < MEL_PER_THREAD; ++cc) {
          const int m = tid + NTHREADS * cc;
          if (m < a.mel) {
            const float w = fb[(size_t)k * a.mel + m];
#pragma unroll
            for (int f = 0; f < FT; ++f) mel[cc][f] = fmaf(mk[f], w, mel[cc][f]);
          }
        }
      }
      __syncthreads();   // mag is rewritten after the next tile
    }
  }

#pragma unroll
  for (int cc = 0; cc < MEL_PER_THREAD; ++cc) {
    const int m = tid + NTHREADS * cc;
    if (m >= a.mel) continue;
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f0 + f < a.frames) {
        const float v = mel[cc][f];
        a.out[((size_t)b * a.frames + f0 + f) * a.mel + m] =
            logf(v <= 0.f ? a.eps : v);
      }
    }
  }
}

extern "C" {

// out (B, frames, mel) = log-mel of x (B, n) through the constants cos_m,
// sin_m (fft, ld) and fbank (ld, mel), the first `bins` bins. Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for arguments the kernel does not take (a hop or
// fft other than HOP and FFT, more than MAX_MEL mel bins). The wrapper has
// checked types, shapes, contiguity and alignment.
int logmel_launch(const void* x, const void* cosm, const void* sinm,
                  const void* fbank, void* out, int B, int n, int hop,
                  int fft, int frames, int bins, int ld, int mel, float eps,
                  void* stream) {
  if (hop != HOP || fft != FFT || B < 1 || B > 65535 || n < 1 ||
      frames != (n + HOP - 1) / HOP || bins < 1 || bins > ld || ld % 32 ||
      mel < 1 || mel > MAX_MEL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.cosm = (const float*)cosm;
  a.sinm = (const float*)sinm;
  a.fbank = (const float*)fbank;
  a.out = (float*)out;
  a.B = B; a.n = n; a.frames = frames; a.bins = bins; a.ld = ld;
  a.mel = mel;
  a.lim = min(ld, (bins + 31) / 32 * 32);
  a.eps = eps;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((frames + FT - 1) / FT, B), block(NTHREADS);
  logmel_kernel<<<grid, block, SMEM_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* logmel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
