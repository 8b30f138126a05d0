// Micro-kernels behind PERF.md's findings on the int8 kernels
// (probes/int8_kernels.py builds and times them on the card): a minimal
// kernel (one load of q, one block reduction, one store) and the same
// with, by variant bit, 1: three more block reductions; 2: 64 cp.async
// copies of 16 bytes and their wait; 4: four cluster barriers, each after
// distributed shared memory stores; 8: 64 dependent shared memory loads;
// 16: 16 dependent L2 loads. mm_floor: the floors of
// csrc/int8_matmul.cu's int8_matmul at its grid (its blocks, Q groups of
// 128 threads, each group walking 16-column units of its block's row
// tile): with read 0 a minimal kernel (a block writes one word); with
// read 1 a kernel that only reads each unit's codes (K rows of 16 bytes,
// a group's loads in flight together) and writes its outputs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NT 256

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NT / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

__global__ void __launch_bounds__(NT)
    micro(const float* q, const int8_t* k, float* out, int variant) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ float red[NT / 32];
  float v = q[blockIdx.x * NT + threadIdx.x];
  if (variant & 2) {
    if (threadIdx.x < 64) {
      const unsigned d =
          (unsigned)__cvta_generic_to_shared(sm + 16 * threadIdx.x);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(k + (size_t)blockIdx.x * 65536 + 1024 * threadIdx.x));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float m = block_max(v, red);
  if (variant & 1) {
    m += block_max(v * 2, red);
    m += block_max(v * 3, red);
    m += block_max(v * 4, red);
  }
  if (variant & 2) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    m += (float)sm[threadIdx.x % 64 * 16];
  }
  if (variant & 4) {
    cg::cluster_group cl = cg::this_cluster();
    for (int i = 0; i < 4; ++i) {
      if (threadIdx.x < 8)
        *cl.map_shared_rank(&red[0], threadIdx.x % cl.num_blocks()) = m;
      cl.sync();
      m += red[0];
    }
  }
  if (variant & 8) {
    int* si = reinterpret_cast<int*>(sm);
    si[threadIdx.x] = threadIdx.x;
    __syncthreads();
    int j = threadIdx.x;
    for (int i = 0; i < 64; ++i) j = si[(j * 7 + 1) % NT];
    m += j;
  }
  if (variant & 16) {
    const int* g =
        reinterpret_cast<const int*>(k) + (size_t)blockIdx.x * 16384;
    int j = threadIdx.x;
    for (int i = 0; i < 16; ++i) j = g[(j * 37 + 11) % 16384] & 16383;
    m += j;
  }
  out[blockIdx.x * NT + threadIdx.x] = m;
}

extern "C" int micro_launch(const void* q, const void* k, void* out,
                            int blocks, int variant, int smem, int cluster,
                            void* stream) {
  cudaFuncSetAttribute(micro, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, micro, (const float*)q,
                                     (const int8_t*)k, (float*)out, variant);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

__global__ void __launch_bounds__(512)
    mm_floor(const int8_t* w, float* out, int B, int K, int N, int rt,
             int read) {
  const int tiles = (B + rt - 1) / rt, units = (N + 15) / 16;
  const int stride = gridDim.x / tiles, r0 = (blockIdx.x % tiles) * rt;
  const int Q = blockDim.x / 128, t = threadIdx.x % 128;
  if (!read) {
    if (threadIdx.x == 0) out[blockIdx.x] = 0.f;
    return;
  }
  for (int u = blockIdx.x / tiles + threadIdx.x / 128 * stride; u < units;
       u += Q * stride) {
    unsigned acc = 0;
#pragma unroll 4
    for (int k = t; k < K; k += 128) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(w + (size_t)k * N + 16 * u);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    for (int o = t; o < rt * 16; o += 128)
      if (r0 + o / 16 < B)
        out[(size_t)(r0 + o / 16) * N + 16 * u + o % 16] = (float)acc;
  }
}

// grid and Q x 128 threads as csrc/int8_matmul.cu's mm_grid gives them
extern "C" int mm_floor_launch(const void* w, void* out, int B, int K,
                               int N, int rt, int read, int grid, int Q,
                               void* stream) {
  mm_floor<<<grid, Q * 128, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, (float*)out, B, K, N, rt, read);
  return (int)cudaGetLastError();
}
