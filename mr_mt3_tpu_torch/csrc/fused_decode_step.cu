// One greedy decoder step through all layers in one launch, for NVIDIA
// Hopper (sm_90a), in the three modes of the TPU kernel: bf16, int8, int4.
//
// Replaces the TPU kernel mr_mt3_tpu/ops/fused_decode.py::fused_decode_step
// (def :564, pallas_call :676, body _make_kernel :494): fds_launch, one
// instantiation per mode (fw_kernel<MODE, KIND_STEP>, the device code of
// fused_decode.cuh, shared with the window). It takes the f32 input row x =
// embed[token] + pos[p] (the wrapper gathers it, as XLA does outside the
// pallas_call) and returns the f32 logits and each layer's new K/V row
// (bf16, or codes with their per-row scales), which the wrapper scatters
// into the cache at p. Its self-attention is the TPU kernel's function,
// not only its tiling: a flash update per live chunk of `chunk` cache
// positions (chunk_base_for: 256 at Lenc 256, 512 at Lenc 320), each int
// chunk requantizing p * vs with its own max and each bf16 chunk rounding
// exp(s - m_running) to bf16, then the current position as an f32
// diagonal term on the unrounded q, k and v.
//
// Bound on the H100 (3.35 TB/s HBM): the step reads the decoder weights
// (bf16 44.0 MB, int8 22.0 MB, int4 11.0 MB plus scales at full width),
// lm_head, the cross K/V and the cache rows < p once; at B = 8 and p = 1023
// that is ~0.02-0.05 ms in bytes (chip_smoke.py::step_bound_ms computes it
// per case). The design is the window's for one step (fused_decode.cuh):
// 65 phases between release/acquire grid barriers, each projection's
// columns over every SM with the next projection's weights in flight
// across the barrier; the chunks of a (row, head) pair split between the
// two blocks of a cluster, which exchange only their chunk maxima; above 8
// rows the projections in 32-column x 8-row tiles over every block. It
// stays latency-bound: each phase a few dependent L2 round trips
// (PERF.md).

#include "fused_decode.cuh"

// above 8 rows: ft_kernel, compiled in fused_decode_step_tiles.cu
extern template int launch_tiles<MODE_BF16, KIND_STEP>(Args, int,
                                                       cudaStream_t);
extern template int launch_tiles<MODE_INT8, KIND_STEP>(Args, int,
                                                       cudaStream_t);
extern template int launch_tiles<MODE_INT4, KIND_STEP>(Args, int,
                                                       cudaStream_t);

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
    case MODE_BF16: return launch_window<MODE_BF16, KIND_STEP>(a, s);
    case MODE_INT8: return launch_window<MODE_INT8, KIND_STEP>(a, s);
    case MODE_INT4: return launch_window<MODE_INT4, KIND_STEP>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef PHASE_TRACE
// the probe build's barrier stamps (ns), n of them from index 0
int fds_phase_trace(unsigned long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase_ns,
                                   n * sizeof(unsigned long long));
}
#endif

const char* fds_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
