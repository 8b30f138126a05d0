// The grouped int8 window (fw_kernel<MODE_INT8, KIND_GROUPED> and, above 8
// rows, ft_kernel<MODE_INT8, KIND_GROUPED>, csrc/fused_decode.cuh): a
// translation unit of the fused_decode_window library of its own
// (ops/cuda_build.py PARTS), compiled beside fused_decode_window.cu so that
// no single nvcc sets the build's time. fdw_grouped_launch reaches it
// through launch_window.

#include "fused_decode.cuh"

template int launch_window<MODE_INT8, KIND_GROUPED>(Args, cudaStream_t);

#ifdef PHASE_TRACE
extern "C" {
// the probe build's barrier stamps of the grouped window (ns), n from 0
int fdw_grouped_phase_trace(unsigned long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase_ns,
                                   n * sizeof(unsigned long long));
}
}
#endif
