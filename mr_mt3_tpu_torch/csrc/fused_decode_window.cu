// Whole-decoder greedy-decode window for NVIDIA Hopper (sm_90a), in the three
// modes of the TPU kernel (bf16, int8, int4), and its grouped int8 form.
//
// Replaces the TPU kernels
//   * mr_mt3_tpu/ops/fused_decode.py::fused_decode_window (pallas_call at
//     :969, body _make_window_kernel :726): fdw_launch, one instantiation
//     per mode (fd_kernel<MODE, KIND_WINDOW>). The cache rows < pos0 are one
//     flash chunk: the port's window takes the softmax over all of them at
//     once (the TPU kernel's 256-position chunks were a VMEM tile);
//   * benchmarks/group_axis_kernel.py::fused_decode_window_grouped
//     (pallas_call at :385, body _make_grouped_kernel :78): fdw_grouped_launch,
//     int8 only (fd_kernel<MODE_INT8, KIND_GROUPED>). It reads the group-major
//     cache and cross K/V (L*G, H, 8, ...) directly, attends the cache rows
//     < pos0 in the TPU kernel's chunks (chunk_base_for: 256 positions at
//     Lenc 256), and rounds the emitted K/V scales to bf16, as the TPU kernel
//     does. On the TPU the group axis made each layer's weights stream once
//     per (token, layer) for all groups; here every launch already streams
//     them once per step for all <= 64 rows, so the grouped form differs from
//     the window only in its layouts and numerics.
// The device code, its cast points and its design are in fused_decode.cuh.
//
// Bound on the H100 (3.35 TB/s HBM, 50 MB L2), MT3 at full width, B = 8,
// Lenc = 256: a token step reads the decoder weights (bf16: 8 x 2,752,512 x
// 2 B = 44.0 MB; int8 22.0 MB; int4 11.0 MB; plus the f32 column scales),
// lm_head, the cross K/V and, at a mean cache position of 512, the self
// K/V: in bf16 ~121 MB, ~36 us per step if every step re-read them from
// HBM. The weights fit in L2, so within a window the weight term is an
// L2-bandwidth term after the first step, and the least time for the
// window as a function (each input read once from HBM) is far lower:
// chip_smoke.py computes that bound, per mode, from each run's shapes.
// The kernel does not approach it: each of the 66 phases of a step is a few
// dependent L2 round trips plus a grid barrier, so the step is
// latency-bound (PERF.md, H100 port section). Fewer phases, more blocks per
// phase, tensor-core products and dp4a over a position-major cache are the
// next steps.

#include "fused_decode.cuh"

extern "C" {

int fdw_pointer_count() { return P_COUNT; }
int fdw_dim_count() { return D_COUNT; }

// Launch one window on `stream`. Returns cudaGetLastError() after the launch
// (0 when it was accepted), or cudaErrorInvalidValue for an unknown mode or
// a chunk below 1.
int fdw_launch(void* const* p, const int* dim, float eps, void* stream) {
  size_t smem = 0;
  const Args a = make_args(p, dim, eps, &smem);
  if (a.chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dim[D_MODE]) {
    case MODE_BF16: return launch<MODE_BF16, KIND_WINDOW>(a, smem, s);
    case MODE_INT8: return launch<MODE_INT8, KIND_WINDOW>(a, smem, s);
    case MODE_INT4: return launch<MODE_INT4, KIND_WINDOW>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch one grouped int8 window (B = G x 8 rows, group-major layouts);
// cudaErrorInvalidValue for another mode, a batch that is not whole groups
// or a chunk below 1.
int fdw_grouped_launch(void* const* p, const int* dim, float eps,
                       void* stream) {
  size_t smem = 0;
  const Args a = make_args(p, dim, eps, &smem);
  if (dim[D_MODE] != MODE_INT8 || a.B % GROUP_ROWS || a.chunk < 1)
    return (int)cudaErrorInvalidValue;
  return launch<MODE_INT8, KIND_GROUPED>(a, smem, (cudaStream_t)stream);
}

const char* fdw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
