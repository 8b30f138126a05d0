// One greedy decoder step through all layers in one launch, for NVIDIA
// Hopper (sm_90a), in the three modes of the TPU kernel: bf16, int8, int4.
//
// Replaces the TPU kernel mr_mt3_tpu/ops/fused_decode.py::fused_decode_step
// (def :564, pallas_call :676, body _make_kernel :494): fds_launch, one
// instantiation per mode (fd_kernel<MODE, KIND_STEP>, the device code of
// fused_decode.cuh). It takes the f32 input row x = embed[token] + pos[p]
// (the wrapper gathers it, as XLA does outside the pallas_call) and returns
// the f32 logits and each layer's new K/V row (bf16, or codes with their
// per-row scales), which the wrapper scatters into the cache at p. Its
// self-attention is the TPU kernel's function, not only its tiling: a flash
// update per live chunk of `chunk` cache positions (chunk_base_for: 256 at
// Lenc 256, 512 at Lenc 320), each int chunk requantizing p * vs with its
// own max and each bf16 chunk rounding exp(s - m_running) to bf16, then the
// current position as an f32 diagonal term on the unrounded q, k and v.
//
// Bound on the H100 (3.35 TB/s HBM): the step reads the decoder weights
// (bf16 44.0 MB, int8 22.0 MB, int4 11.0 MB plus scales at full width),
// lm_head, the cross K/V and the cache rows < p once; at B = 8 and p = 1023
// that is ~0.02-0.04 ms in bytes (chip_smoke.py::step_bound_ms computes it
// per case). The design is the window kernel's with one step: 65 phases
// between grid barriers, latency-bound like the window (PERF.md).

#include "fused_decode.cuh"

extern "C" {

int fds_pointer_count() { return P_COUNT; }
int fds_dim_count() { return D_COUNT; }

// Launch one step on `stream` (dim[D_T] must be 1 and dim[D_POS0] the
// position). Returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for an unknown mode, T != 1 or a chunk
// below 1.
int fds_launch(void* const* p, const int* dim, float eps, void* stream) {
  size_t smem = 0;
  const Args a = make_args(p, dim, eps, &smem);
  if (a.T != 1 || a.chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dim[D_MODE]) {
    case MODE_BF16: return launch<MODE_BF16, KIND_STEP>(a, smem, s);
    case MODE_INT8: return launch<MODE_INT8, KIND_STEP>(a, smem, s);
    case MODE_INT4: return launch<MODE_INT4, KIND_STEP>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fds_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
