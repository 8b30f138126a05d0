// Unscaled-softmax attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mr_mt3_tpu/ops/train_attention.py::_fwd_kernel
// (pallas_call at :185 in _call_fwd_local, behind fused_attention :166), the
// forward only. Per (batch row, head) it computes, as the TPU kernel does:
//   s = q . k^T from the inputs' values with f32 sums; NOT scaled (T5);
//   columns >= kv_valid, and with `causal` columns > row, set to -1e30;
//   m = max(s), e = exp(s - m), p = e / sum(e), all in f32;
//   p rounded to bf16 BEFORE the value sum;
//   o = p . v with f32 sums, rounded to bf16.
// bf16 only: 'auto' routes only bf16 models here (models/mt3.py), and the
// wrapper raises for other types on the card.
// The probabilities are normalized before they are rounded, as the TPU
// kernel and the einsum path do: a one-pass flash kernel that divides o by
// the row sum at the end rounds other values. So the kernel must know each
// row's final max and sum before it rounds p, and walks K twice. Built
// without --use_fast_math. exp(s - m) is taken as exp2((s - m) log2(e))
// (the ex2 unit) and p = e / l as e times 1 / l (one IEEE division a row):
// both move p by a few f32 ulps, far below its bf16 step, and ATTN_BOUNDS
// hold unchanged (fused_attention.cuh). A masked
// column's e is exp(-1e30 - m) = 0 exactly, so the kernel gives it p = 0
// without computing it; a tile that every row of a warp sees whole skips
// the mask tests.
//
// Layout: q and out (B, Lq, H, D), k and v (B, Lk, H, D), contiguous, in the
// model's layout: no transpose pass (that pass was a TPU block-shape rule,
// train_attention.py:136-149). Lk is the padded length (a multiple of 128,
// ops/train_attention.py::_pad_kv); only the keys below kv_valid are read.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16): the memory encoder
// call, B = 8, H = 6, L = 1024, D = 64, moves 4 x 6.3 MB (q, k, v, out) and
// does 4 B H L^2 D = 12.9 GFLOP, about 13 us on the tensor cores: it is
// bound by operations. chip_smoke.py computes the bound of each case.
// This design does three products where the function needs two (sweep 1
// repeats q k^T), so it can reach at best 2/3 of that bound; and mma.sync
// reaches a part of the tensor cores' rate that only wgmma reaches in full.
//
// Design (device code shared with the backward in fused_attention.cuh):
// one block of 4 warps per (64 query rows, head, batch row), each warp 16
// rows; grid order puts the causal blocks with the most keys first. K and
// V stream through a two-stage cp.async ring in tiles of 64 keys, the
// next tile in flight while the tensor cores (mma.sync m16n8k16 from
// ldmatrix, on rows padded to a conflict-free stride) work on this one.
//   Sweep 1: s = q k^T per tile, in registers; the running row max m and
//     sum l in f32 (online: l rescaled by exp(m_old - m_new)).
//   Sweep 2: s again (the same products, so the same bits); p = exp(s -
//     m) / l, masked to 0, rounded to bf16 in registers, where the score
//     accumulator's layout is the next product's A fragments; o += p v
//     (v read transposed by ldmatrix) in f32 registers.
// Only tiles with a visible column are walked (up to kv_valid, and with
// `causal` up to the block's last row; a warp skips the tiles past its own
// last row). No score rows sit in shared memory, so shared memory does
// not grow with Lk: 45 KB at D 64, 85 KB at D 128. The head width pads to
// a multiple of 16 with zeros in shared memory (D 24: 32, the pad
// zero-filled by the copy, never read from the next head). The ragged
// last query tile (Lq a multiple of 8, not of 64) reads zero rows past Lq
// and stores only the rows below it.
// Not done yet: wgmma with TMA and a producer warp, 128-row blocks, and a
// persistent grid.

#include "fused_attention.cuh"

using namespace fa;

#define NWARPS 4
#define NTHREADS (32 * NWARPS)
#define ROWS (WARP_ROWS * NWARPS)   // query rows per block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Lq, Lk, H, D, kv_valid, causal;
};

template <int Dp>
__host__ __device__ constexpr size_t smem_bytes_dp() {
  return tile_bytes(ROWS, Dp) + 4 * tile_bytes(TILE, Dp);  // q; k, v x 2
}

template <int Dp>
__global__ void __launch_bounds__(NTHREADS) faf_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // ROWS rows
  bf16* ks = qs + ROWS * lds(Dp);                 // 2 stages x TILE rows
  bf16* vs = ks + 2 * TILE * lds(Dp);             // 2 stages x TILE rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = tile * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(ROWS, a.Lq - row0);
  const size_t hd = (size_t)a.H * a.D;
  const bf16* Q = static_cast<const bf16*>(a.q) +
                  ((size_t)b * a.Lq + row0) * hd + (size_t)h * a.D;
  const size_t kvoff = (size_t)b * a.Lk * hd + (size_t)h * a.D;
  const bf16* K = static_cast<const bf16*>(a.k) + kvoff;
  const bf16* V = static_cast<const bf16*>(a.v) + kvoff;
  int nkeys = a.kv_valid;   // the keys any row of the block can see
  if (a.causal) nkeys = min(nkeys, row0 + nrows);
  const int ntiles = (nkeys + TILE - 1) / TILE;
  const int steps = 2 * ntiles;   // sweep 1 (K tiles), sweep 2 (K and V)

  auto load_step = [&](int i) {
    const int k0 = (i % ntiles) * TILE, st = i & 1;
    load_tile<TILE, Dp, NTHREADS>(ks + st * TILE * lds(Dp),
                                  K + (size_t)k0 * hd, hd, nkeys - k0, a.D);
    if (i >= ntiles)
      load_tile<TILE, Dp, NTHREADS>(vs + st * TILE * lds(Dp),
                                    V + (size_t)k0 * hd, hd, nkeys - k0, a.D);
  };
  load_tile<ROWS, Dp, NTHREADS>(qs, Q, hd, nrows, a.D);
  load_step(0);
  cp_async_commit();

  const int wrow0 = row0 + warp * WARP_ROWS;
  const int row[2] = {wrow0 + (lane >> 2), wrow0 + (lane >> 2) + 8};
  const bf16* qw = qs + warp * WARP_ROWS * lds(Dp);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, unused[2];
  float rl[2];   // 1 / l, once sweep 1 is done
  float o[Dp / 8][4] = {};
  float s[NB][4];
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();   // step i's tiles have landed
    __syncthreads();
    const int k0 = (i % ntiles) * TILE, st = i & 1;
    const bf16* kt = ks + st * TILE * lds(Dp);
    const bool full = tile_visible(wrow0, k0, a.kv_valid, a.causal);
    // with `causal`, a tile past this warp's last row is all masked
    if (!(a.causal && k0 > wrow0 + WARP_ROWS - 1)) {
      nt_product<Dp>(s, qw, kt, lane);
      if (i < ntiles) {
        if (full)
          online_stats<false, false>(s, s, row, k0, a.kv_valid, a.causal, m,
                                     l, unused);
        else
          online_stats<false, true>(s, s, row, k0, a.kv_valid, a.causal, m,
                                    l, unused);
      } else {
        if (full)
          probabilities<false>(s, m, rl, row, k0, a.kv_valid, a.causal);
        else
          probabilities<true>(s, m, rl, row, k0, a.kv_valid, a.causal);
        uint32_t pf[NB / 2][4];
        to_fragments(pf, s);
        nn_product<Dp>(o, pf, vs + st * TILE * lds(Dp), lane);
      }
    }
    if (i == ntiles - 1)   // the row statistics are complete
      for (int r = 0; r < 2; ++r) rl[r] = 1.f / l[r];
    __syncthreads();   // the stage is free for step i + 2's copy
  }
  bf16* O = static_cast<bf16*>(a.out) + ((size_t)b * a.Lq + row0) * hd +
            (size_t)h * a.D;
  store_rows<Dp>(O, hd, o, warp * WARP_ROWS, nrows, a.D, lane);
}

// ---- launch -------------------------------------------------------------

template <int Dp>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_dp<Dp>();
  cudaError_t err = cudaFuncSetAttribute(
      faf_kernel<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + ROWS - 1) / ROWS, a.H, a.B), block(NTHREADS);
  faf_kernel<Dp><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

static size_t smem_bytes(int D) {
  switch (padded_d(D)) {
    case 16: return smem_bytes_dp<16>();
    case 32: return smem_bytes_dp<32>();
    case 48: return smem_bytes_dp<48>();
    case 64: return smem_bytes_dp<64>();
    case 80: return smem_bytes_dp<80>();
    case 96: return smem_bytes_dp<96>();
    case 112: return smem_bytes_dp<112>();
    case 128: return smem_bytes_dp<128>();
    default: return 0;
  }
}

extern "C" {

// The kernel's constants and shared-memory size, so the wrapper sizes and
// checks alike.
int faf_rows() { return ROWS; }
int faf_tile() { return TILE; }
int faf_max_d() { return MAX_D; }
long long faf_smem_bytes(int D) { return (long long)smem_bytes(D); }

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 when
// it was accepted), or cudaErrorInvalidValue for arguments the kernel does
// not take. The wrapper has checked shapes, the bf16 type, contiguity and
// 16-byte alignment.
int faf_launch(const void* q, const void* k, const void* v, void* out, int B,
               int Lq, int Lk, int H, int D, int kv_valid, int causal,
               void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 8 || D > MAX_D || D % 8 ||
      kv_valid < 1 || kv_valid > Lk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.D = D;
  a.kv_valid = kv_valid; a.causal = causal ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (padded_d(D)) {
    case 16: return (int)launch<16>(a, st);
    case 32: return (int)launch<32>(a, st);
    case 48: return (int)launch<48>(a, st);
    case 64: return (int)launch<64>(a, st);
    case 80: return (int)launch<80>(a, st);
    case 96: return (int)launch<96>(a, st);
    case 112: return (int)launch<112>(a, st);
    case 128: return (int)launch<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* faf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
