// The step above 8 rows (ft_kernel<MODE, KIND_STEP>, csrc/fused_decode.cuh):
// a translation unit of the fused_decode_step library of its own
// (ops/cuda_build.py PARTS), compiled beside fused_decode_step.cu so that
// no single nvcc sets the build's time. fds_launch reaches it through
// launch_tiles.

#include "fused_decode.cuh"

template int launch_tiles<MODE_BF16, KIND_STEP>(Args, int, cudaStream_t);
template int launch_tiles<MODE_INT8, KIND_STEP>(Args, int, cudaStream_t);
template int launch_tiles<MODE_INT4, KIND_STEP>(Args, int, cudaStream_t);

#ifdef PHASE_TRACE
extern "C" {
// the probe build's barrier stamps of ft_kernel (ns), n from index 0
int fds_tiles_phase_trace(unsigned long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase_ns,
                                   n * sizeof(unsigned long long));
}
}
#endif
