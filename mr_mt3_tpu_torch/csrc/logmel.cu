// Fused log-mel spectrogram for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mr_mt3_tpu/ops/mel_pallas.py::logmel_pallas
// (pallas_call :137, _kernel :68). Per segment b and frame f it computes
// the TPU kernel's function:
//   1. frame f is window samples x[f * 128 + t], t < 2048, zero past the
//      segment's n samples (pad_end framing), times the periodic Hann
//      window;
//   2. the spectrum's magnitude |X[k]|, k < 1025 (the TPU kernel takes it
//      as a DFT by products against cos / -sin constants);
//   3. mel[f, m] = sum_k |X[f, k]| fbank[k, m];
//   4. out = log(mel <= 0 ? eps : mel).
//
// Bound on the H100 (67 TFLOP/s f32 on the CUDA cores; 3.35 TB/s HBM): a
// real FFT of 2048 samples is ~2.5 N log2 N = 56k operations a frame, the
// window, magnitudes, the mel products over the filterbank's ~1934
// nonzeros and the log add ~12k; against the audio and the output (~0.5
// MB a segment) it is bound by operations: 0.0020 ms at B = 8 segments of
// 32768 samples, 0.0163 ms at B = 64 (chip_smoke.py::logmel_bound_ms).
//
// Design. The transform is an FFT in shared memory, in f32: each frame's
// 2048 windowed samples are packed as 1024 complex values z[n] = x[2n] +
// i x[2n + 1] (written at the bit-reversed index), a radix-2 decimation-in-
// time FFT of 1024 points runs in place over 10 stages, and the real-input
// post-pass X[k] = E[k] + W^k O[k], with E = (Z[k] + conj Z[1024 - k]) / 2
// and O = -i (Z[k] - conj Z[1024 - k]) / 2, gives both X[k] and X[1024 - k]
// from one pair of values. One block holds FPB = 8 frames of one segment
// (8 KB each) and 256 threads: 16 butterflies a thread a stage, one
// __syncthreads between stages. The twiddles W^k = (cos, -sin)(2 pi k /
// 2048), k <= 1024, and the window come from tables the host computes in
// float64 and stores as f32 (ops/mel_kernel.py::_fft_constants), copied to
// shared memory once a block; the 1024-point transform's twiddles are the
// even entries. The magnitudes overwrite the frame's buffer; the mel
// projection then runs over each filter's contiguous range of nonzero bins
// (first to last nonzero of its column of the filterbank, packed on the
// host), not the dense 1025 x 512 product: 2 mel bins x 8 frames a thread,
// bins in ascending order. Then safe_log and one store per output. One
// launch a call; the (frames, 1025) spectrum never leaves shared memory.
// Built without --use_fast_math: sqrtf and logf are the IEEE ones.
// Not done: radix-4 or register-resident stages (fewer barriers and
// shared-memory passes), more frames a block to read the tables fewer
// times at large B.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define HOP 128                  // hop width (samples)
#define FFT 2048                 // window (samples)
#define HALF (FFT / 2)           // points of the complex FFT
#define LOG_HALF 10
#define BINS (HALF + 1)          // spectrum bins 0..1024
#define NTHREADS 256
#define FPB 8                    // frames a block
#define MAX_MEL 512
#define MEL_PER_THREAD (MAX_MEL / NTHREADS)
#define PAIRS (HALF / 2 + 1)     // post-pass pairs (k, 1024 - k), k <= 512
#define PAIRS_PER_THREAD ((FPB * PAIRS + NTHREADS - 1) / NTHREADS)

struct Args {
  const float* x;        // (B, n) samples
  const float2* tw;      // (BINS) (cos, -sin)(2 pi k / FFT)
  const float* win;      // (FFT) periodic Hann
  const int* mel_lo;     // (mel) first nonzero bin of each filter
  const int* mel_len;    // (mel) bins in its range
  const int* mel_off;    // (mel) offset of its weights in mel_w
  const float* mel_w;    // the ranges' weights, filter after filter
  float* out;            // (B, frames, mel)
  int B, n, frames, mel;
  float eps;
};

constexpr size_t SMEM_BYTES =
    (size_t)FPB * HALF * sizeof(float2) + BINS * sizeof(float2) +
    FFT * sizeof(float);

// X[k] from A = Z[k] and Bc = conj(Z[1024 - k]) with W^k = w
__device__ __forceinline__ float spectrum_mag(float2 a, float2 bc, float2 w) {
  const float er = 0.5f * (a.x + bc.x), ei = 0.5f * (a.y + bc.y);
  const float orr = 0.5f * (a.y - bc.y), oi = -0.5f * (a.x - bc.x);
  const float re = er + (w.x * orr - w.y * oi);
  const float im = ei + (w.x * oi + w.y * orr);
  return sqrtf(re * re + im * im);
}

__global__ void __launch_bounds__(NTHREADS, 2) logmel_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);   // [FPB][HALF]
  float2* tw = buf + FPB * HALF;                    // [BINS]
  float* win = reinterpret_cast<float*>(tw + BINS); // [FFT]

  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * FPB;
  for (int i = tid; i < BINS; i += NTHREADS) tw[i] = a.tw[i];
  for (int i = tid; i < FFT; i += NTHREADS) win[i] = a.win[i];
  __syncthreads();

  // windowed frames, packed as complex values at bit-reversed indices
  const float* x = a.x + (size_t)b * a.n;
  for (int i = tid; i < FPB * HALF; i += NTHREADS) {
    const int f = i / HALF, j = i % HALF;
    const long s = (long)(f0 + f) * HOP + 2 * j;
    const float re = s < a.n ? x[s] : 0.f;
    const float im = s + 1 < a.n ? x[s + 1] : 0.f;
    buf[f * HALF + (__brev((unsigned)j) >> (32 - LOG_HALF))] =
        make_float2(re * win[2 * j], im * win[2 * j + 1]);
  }

  // radix-2 decimation in time: span h = 2^s, twiddle W_1024^j = tw[2^(10-s) j]
  for (int s = 0; s < LOG_HALF; ++s) {
    __syncthreads();
    const int h = 1 << s;
#pragma unroll 4
    for (int g = tid; g < FPB * HALF / 2; g += NTHREADS) {
      const int f = g / (HALF / 2), bi = g % (HALF / 2);
      const int j = bi & (h - 1);
      const int i0 = f * HALF + ((bi - j) << 1) + j, i1 = i0 + h;
      const float2 w = tw[j << (LOG_HALF - s)];
      const float2 u = buf[i0], v = buf[i1];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      buf[i0] = make_float2(u.x + tr, u.y + ti);
      buf[i1] = make_float2(u.x - tr, u.y - ti);
    }
  }
  __syncthreads();

  // real-input post-pass: |X[k]| and |X[1024 - k]| from Z[k], Z[1024 - k]
  float lo[PAIRS_PER_THREAD], hi[PAIRS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < PAIRS_PER_THREAD; ++r) {
    const int g = tid + r * NTHREADS;
    if (g < FPB * PAIRS) {
      const int f = g / PAIRS, k = g % PAIRS;
      const float2 zk = buf[f * HALF + k];
      const float2 zm = buf[f * HALF + ((HALF - k) & (HALF - 1))];
      lo[r] = spectrum_mag(zk, make_float2(zm.x, -zm.y), tw[k]);
      hi[r] = spectrum_mag(zm, make_float2(zk.x, -zk.y), tw[HALF - k]);
    }
  }
  __syncthreads();
  // magnitudes overwrite the frame's buffer: mag[f][k] at float f*2*HALF+k
  float* mag = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int r = 0; r < PAIRS_PER_THREAD; ++r) {
    const int g = tid + r * NTHREADS;
    if (g < FPB * PAIRS) {
      const int f = g / PAIRS, k = g % PAIRS;
      mag[f * 2 * HALF + k] = lo[r];
      mag[f * 2 * HALF + HALF - k] = hi[r];
    }
  }
  __syncthreads();

  // mel over each filter's nonzero range, then safe_log
#pragma unroll
  for (int c = 0; c < MEL_PER_THREAD; ++c) {
    const int m = tid + NTHREADS * c;
    if (m >= a.mel) continue;
    float acc[FPB];
#pragma unroll
    for (int f = 0; f < FPB; ++f) acc[f] = 0.f;
    const int k0 = a.mel_lo[m], len = a.mel_len[m];
    const float* w = a.mel_w + a.mel_off[m];
    for (int i = 0; i < len; ++i) {
      const float wk = __ldg(w + i);
#pragma unroll
      for (int f = 0; f < FPB; ++f)
        acc[f] = fmaf(mag[f * 2 * HALF + k0 + i], wk, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < FPB; ++f) {
      if (f0 + f < a.frames) {
        const float v = acc[f];
        a.out[((size_t)b * a.frames + f0 + f) * a.mel + m] =
            logf(v <= 0.f ? a.eps : v);
      }
    }
  }
}

extern "C" {

// out (B, frames, mel) = log-mel of x (B, n) through the twiddles tw (1025,
// 2), the window win (2048) and the filterbank's nonzero ranges (mel_lo,
// mel_len, mel_off per filter, their weights mel_w). Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for arguments the kernel does not take (a hop or
// fft other than HOP and FFT, more than MAX_MEL mel bins). The wrapper has
// checked types, shapes and contiguity, and that every range lies in the
// 1025 bins.
int logmel_launch(const void* x, const void* tw, const void* win,
                  const void* mel_lo, const void* mel_len,
                  const void* mel_off, const void* mel_w, void* out, int B,
                  int n, int hop, int fft, int frames, int mel, float eps,
                  void* stream) {
  if (hop != HOP || fft != FFT || B < 1 || B > 65535 || n < 1 ||
      frames != (n + HOP - 1) / HOP || mel < 1 || mel > MAX_MEL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.tw = (const float2*)tw;
  a.win = (const float*)win;
  a.mel_lo = (const int*)mel_lo;
  a.mel_len = (const int*)mel_len;
  a.mel_off = (const int*)mel_off;
  a.mel_w = (const float*)mel_w;
  a.out = (float*)out;
  a.B = B; a.n = n; a.frames = frames; a.mel = mel;
  a.eps = eps;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((frames + FPB - 1) / FPB, B), block(NTHREADS);
  void* args[] = {&a};
  err = cudaLaunchKernel((const void*)logmel_kernel, grid, block, args,
                         SMEM_BYTES, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

const char* logmel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
