// Unscaled-softmax attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mr_mt3_tpu/ops/train_attention.py::_bwd_kernel
// (pallas_call at :204 in _call_bwd_local, the VJP _fused_bwd :304). Per
// (batch row, head) it computes, as the TPU kernel does:
//   s  = q . k^T with f32 sums, NOT scaled (T5); columns >= kv_valid, and
//        with `causal` columns > row, masked;
//   p  = softmax(s) in f32, normalized;   pb = bf16(p);
//   dv = pb^T . dO   (f32 sums);
//   dp = dO . v^T    (f32);
//   ds = p * (dp - rowsum(dp * p))       (f32; delta from f32 p and f32 dp,
//        NOT FlashAttention-2's rowsum(dO * O): O was computed from the
//        bf16-rounded p, so the two differ);
//   dq = bf16(ds) . k,  dk = bf16(ds)^T . q  (f32 sums);
// dq, dk and dv rounded to bf16. Built without --use_fast_math; exp(s - m)
// as exp2((s - m) log2(e)) and p = e / l as e times 1 / l, as in the
// forward (fused_attention.cuh): ATTN_BWD_BOUNDS hold unchanged. A masked
// column has p = 0 and so ds = 0 exactly; K rows past kv_valid get
// exact-zero dk and dv (the wrapper's autograd trims them with the
// padding).
//
// Layout: q, dO, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D), contiguous,
// bf16, the model's layout. Lk is the padded length (a multiple of 128,
// ops/train_attention.py::_pad_kv).
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16): at the memory
// encoder's training shape, B = 12, H = 6, L = 1024, D = 64, the five
// products (q k^T, dO v^T, pb^T dO, ds k, ds^T q) are 5 x 2 B H L^2 D = 48
// GFLOP, about 49 us on the tensor cores, while its seven tensors of 9.4 MB
// move in about 20 us: it is bound by operations. chip_smoke.py computes the
// bound of each case from the columns each row sees. This design does nine
// products where the function needs five (below), so it can reach at best
// 5/9 of that bound, and mma.sync only a part of the tensor cores' rate.
//
// Design: two kernels, deterministic, no atomics; the tile loads, the
// products (mma.sync m16n8k16 from ldmatrix on conflict-free padded rows)
// and the row statistics are fused_attention.cuh's, as in the forward.
//  (a) fab_dq_kernel, one block of 4 warps per (64 query rows, head, batch
//      row), each warp 16 rows. K and V tiles of 64 keys stream through a
//      two-stage cp.async ring.
//      Sweep AB: s = q k^T and dp = dO v^T per tile; the online row max m,
//        sum l = sum exp(s - m) and u = sum exp(s - m) dp (both rescaled
//        when m grows), so delta = u / l = sum p dp after the last tile:
//        the forward's sweep 1 and the delta sweep merged into one, which
//        saves a product a tile (ATTN_BWD_BOUNDS hold unchanged on it).
//        m, 1 / l and delta go to the (3, B, H, Lq) f32 scratch.
//      Sweep C: s and dp again (the same bits); p = exp(s - m) / l; ds =
//        p (dp - delta) in f32, rounded to bf16 in registers; dq += ds k
//        (k read transposed by ldmatrix), in f32 registers.
//      5 products per tile.
//  (b) fab_dkdv_kernel, one block of 4 warps per (64 keys, head, batch
//      row), each warp 16 keys; K and V stay in shared memory, Q and dO
//      tiles of 64 rows (and the rows' m, l, delta) stream through the
//      ring; with `causal` only the tiles from the block's first key on.
//      Each tile: s^T = k q^T; p^T from the stored statistics; dv += bf16
//      (p)^T dO; dp^T = v dO^T; ds^T = p^T (dp^T - delta); dk += bf16
//      (ds)^T q; all in registers, the query tiles summed in one fixed
//      order. 4 products per tile.
// (a) and (b) recompute p with the products in other roles (q k^T against
// k q^T), so their p may differ in the last bit of f32; the bounds hold.
// No score rows sit in shared memory, so shared memory does not grow with
// Lk: 54 and 55.5 KB at D 64. The head width pads to a multiple of 16 with
// zeros (D 24: 32, never read from the next head); rows past Lq are zero
// and masked.
// Not done yet: wgmma with TMA and a producer warp, 128-row blocks, and a
// persistent grid.

#include "fused_attention.cuh"

using namespace fa;

#define NWARPS 4
#define NTHREADS (32 * NWARPS)
#define ROWS (WARP_ROWS * NWARPS)   // (a): query rows per block
#define KB (WARP_ROWS * NWARPS)     // (b): keys per block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;   // (3, B, H, Lq): row max, 1 / row sum, delta
  int B, Lq, Lk, H, D, kv_valid, causal;
};

template <int Dp>
__host__ __device__ constexpr size_t smem_dq_dp() {
  return 2 * tile_bytes(ROWS, Dp) + 4 * tile_bytes(TILE, Dp);
}

template <int Dp>
__host__ __device__ constexpr size_t smem_dkdv_dp() {
  return 2 * tile_bytes(KB, Dp) + 4 * tile_bytes(TILE, Dp) +
         2 * 3 * TILE * sizeof(float);
}

// ---- (a): statistics, delta and dq per 64-row query tile -----------------

template <int Dp>
__global__ void __launch_bounds__(NTHREADS) fab_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // ROWS rows
  bf16* dos = qs + ROWS * lds(Dp);                // ROWS rows
  bf16* ks = dos + ROWS * lds(Dp);                // 2 stages x TILE rows
  bf16* vs = ks + 2 * TILE * lds(Dp);             // 2 stages x TILE rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = tile * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(ROWS, a.Lq - row0);
  const size_t hd = (size_t)a.H * a.D;
  const size_t qoff = ((size_t)b * a.Lq + row0) * hd + (size_t)h * a.D;
  const size_t kvoff = (size_t)b * a.Lk * hd + (size_t)h * a.D;
  const bf16* K = static_cast<const bf16*>(a.k) + kvoff;
  const bf16* V = static_cast<const bf16*>(a.v) + kvoff;
  int nkeys = a.kv_valid;   // the keys any row of the block can see
  if (a.causal) nkeys = min(nkeys, row0 + nrows);
  const int ntiles = (nkeys + TILE - 1) / TILE;
  const int steps = 2 * ntiles;   // sweep AB, then sweep C

  auto load_step = [&](int i) {
    const int k0 = (i % ntiles) * TILE, st = i & 1;
    load_tile<TILE, Dp, NTHREADS>(ks + st * TILE * lds(Dp),
                                  K + (size_t)k0 * hd, hd, nkeys - k0, a.D);
    load_tile<TILE, Dp, NTHREADS>(vs + st * TILE * lds(Dp),
                                  V + (size_t)k0 * hd, hd, nkeys - k0, a.D);
  };
  load_tile<ROWS, Dp, NTHREADS>(qs, static_cast<const bf16*>(a.q) + qoff, hd,
                                nrows, a.D);
  load_tile<ROWS, Dp, NTHREADS>(dos, static_cast<const bf16*>(a.dout) + qoff,
                                hd, nrows, a.D);
  load_step(0);
  cp_async_commit();

  const int wrow0 = row0 + warp * WARP_ROWS, t = lane & 3;
  const int row[2] = {wrow0 + (lane >> 2), wrow0 + (lane >> 2) + 8};
  const bf16* qw = qs + warp * WARP_ROWS * lds(Dp);
  const bf16* dow = dos + warp * WARP_ROWS * lds(Dp);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  // 1 / l and delta, once sweep AB is done
  float rl[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float dq[Dp / 8][4] = {};
  float s[NB][4], dp[NB][4];
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
      nt_product<Dp>(dp, dow, vs + st * TILE * lds(Dp), lane);
      if (i < ntiles) {
        if (full)
          online_stats<true, false>(s, dp, row, k0, a.kv_valid, a.causal, m,
                                    l, u);
        else
          online_stats<true, true>(s, dp, row, k0, a.kv_valid, a.causal, m,
                                   l, u);
      } else {
        if (full)
          probabilities<false>(s, m, rl, row, k0, a.kv_valid, a.causal);
        else
          probabilities<true>(s, m, rl, row, k0, a.kv_valid, a.causal);
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] *= dp[n][e] - delta[e >> 1];   // ds = p (dp - delta)
        uint32_t df[NB / 2][4];
        to_fragments(df, s);
        nn_product<Dp>(dq, df, kt, lane);
      }
    }
    if (i == ntiles - 1) {   // the row statistics are complete
      const size_t bhl = (size_t)a.B * a.H * a.Lq;
      const size_t sbase = ((size_t)b * a.H + h) * a.Lq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rl[r] = 1.f / l[r];
        delta[r] = u[r] / l[r];
        if (t == 0 && row[r] < a.Lq) {
          a.stats[sbase + row[r]] = m[r];
          a.stats[bhl + sbase + row[r]] = rl[r];
          a.stats[2 * bhl + sbase + row[r]] = delta[r];
        }
      }
    }
    __syncthreads();   // the stage is free for step i + 2's copy
  }
  store_rows<Dp>(static_cast<bf16*>(a.dq) + qoff, hd, dq, warp * WARP_ROWS,
                 nrows, a.D, lane);
}

// ---- (b): dk and dv per 64-key block --------------------------------------

// p^T = exp(s - m) / l over a transposed score tile in place (this lane's
// keys key[0], key[1]; query rows r0 + 8 n + 2 t + (e & 1)), from the
// tile's stored m and 1 / l (sm[r], sm[TILE + r]); 0 where masked
// or past Lq (MASK false when every row of the tile sees every key).
template <bool MASK>
__device__ __forceinline__ void probabilities_t(float (&s)[NB][4],
                                                const float* sm,
                                                const int (&key)[2], int r0,
                                                int Lq, int kv_valid,
                                                bool causal) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int r = 8 * n + 2 * t;
    const float2 mr = *reinterpret_cast<const float2*>(sm + r);
    const float2 rl = *reinterpret_cast<const float2*>(sm + TILE + r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + r + (e & 1);
      const float p =
          exp_shifted(s[n][e], (e & 1) ? mr.y : mr.x) * ((e & 1) ? rl.y : rl.x);
      s[n][e] = !MASK || (row < Lq &&
                          visible(row, key[e >> 1], kv_valid, causal))
                    ? p
                    : 0.f;
    }
  }
}

template <int Dp>
__global__ void __launch_bounds__(NTHREADS) fab_dkdv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // KB rows
  bf16* vs = ks + KB * lds(Dp);                   // KB rows
  bf16* qs = vs + KB * lds(Dp);                   // 2 stages x TILE rows
  bf16* dos = qs + 2 * TILE * lds(Dp);            // 2 stages x TILE rows
  // 2 stages x (m, 1 / l, delta) x TILE rows
  float* sts = reinterpret_cast<float*>(dos + 2 * TILE * lds(Dp));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * KB, h = blockIdx.y, b = blockIdx.z;
  const size_t hd = (size_t)a.H * a.D;
  const size_t kvoff = ((size_t)b * a.Lk + j0) * hd + (size_t)h * a.D;
  const size_t qbase = (size_t)b * a.Lq * hd + (size_t)h * a.D;
  const size_t bhl = (size_t)a.B * a.H * a.Lq;
  const size_t sbase = ((size_t)b * a.H + h) * a.Lq;
  const int nk = min(KB, a.kv_valid - j0);   // keys this block can see
  // with `causal`, rows before j0 see none of these keys
  const int rtile0 = a.causal ? j0 / TILE : 0;
  const int steps = nk > 0 ? max(0, (a.Lq + TILE - 1) / TILE - rtile0) : 0;
  float dk[Dp / 8][4] = {}, dv[Dp / 8][4] = {};

  if (steps > 0) {
    auto load_step = [&](int i) {
      const int r0 = (rtile0 + i) * TILE, st = i & 1;
      const int nr = a.Lq - r0;
      load_tile<TILE, Dp, NTHREADS>(qs + st * TILE * lds(Dp),
                                    static_cast<const bf16*>(a.q) + qbase +
                                        (size_t)r0 * hd,
                                    hd, nr, a.D);
      load_tile<TILE, Dp, NTHREADS>(dos + st * TILE * lds(Dp),
                                    static_cast<const bf16*>(a.dout) + qbase +
                                        (size_t)r0 * hd,
                                    hd, nr, a.D);
      for (int x = threadIdx.x; x < 3 * TILE; x += NTHREADS) {
        const int which = x / TILE, r = x - which * TILE;
        const float* src = a.stats + which * bhl + sbase + r0 + r;
        cp_async4(sts + st * 3 * TILE + x, r < nr ? src : a.stats, r < nr);
      }
    };
    load_tile<KB, Dp, NTHREADS>(ks, static_cast<const bf16*>(a.k) + kvoff, hd,
                                nk, a.D);
    load_tile<KB, Dp, NTHREADS>(vs, static_cast<const bf16*>(a.v) + kvoff, hd,
                                nk, a.D);
    load_step(0);
    cp_async_commit();

    const int kw0 = j0 + warp * WARP_ROWS, t = lane & 3;
    const int key[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
    const bf16* kw = ks + warp * WARP_ROWS * lds(Dp);
    const bf16* vw = vs + warp * WARP_ROWS * lds(Dp);
    float s[NB][4], dp[NB][4];
    uint32_t f[NB / 2][4];
    for (int i = 0; i < steps; ++i) {
      if (i + 1 < steps) load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();   // step i's tiles have landed
      __syncthreads();
      const int r0 = (rtile0 + i) * TILE, st = i & 1;
      const bf16* qt = qs + st * TILE * lds(Dp);
      const bf16* dot = dos + st * TILE * lds(Dp);
      const float* sm = sts + st * 3 * TILE;   // m, 1 / l, delta
      // skip when every key of this warp is masked for every row here
      if (kw0 < a.kv_valid && !(a.causal && r0 + TILE - 1 < kw0)) {
        // every row of the tile sees every key of the warp: no mask tests
        const bool full = r0 + TILE <= a.Lq &&
                          kw0 + WARP_ROWS <= a.kv_valid &&
                          !(a.causal && kw0 + WARP_ROWS - 1 > r0);
        nt_product<Dp>(s, kw, qt, lane);   // s^T: (key, row)
        if (full)
          probabilities_t<false>(s, sm, key, r0, a.Lq, a.kv_valid, a.causal);
        else
          probabilities_t<true>(s, sm, key, r0, a.Lq, a.kv_valid, a.causal);
        to_fragments(f, s);
        nn_product<Dp>(dv, f, dot, lane);
        nt_product<Dp>(dp, vw, dot, lane);   // dp^T: (key, row)
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 dr =
              *reinterpret_cast<const float2*>(sm + 2 * TILE + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] *= dp[n][e] - ((e & 1) ? dr.y : dr.x);
        }
        to_fragments(f, s);
        nn_product<Dp>(dk, f, qt, lane);
      }
      __syncthreads();   // the stage is free for step i + 2's copy
    }
  }
  const size_t koff = ((size_t)b * a.Lk + j0) * hd + (size_t)h * a.D;
  store_rows<Dp>(static_cast<bf16*>(a.dv) + koff, hd, dv, warp * WARP_ROWS,
                 KB, a.D, lane);
  store_rows<Dp>(static_cast<bf16*>(a.dk) + koff, hd, dk, warp * WARP_ROWS,
                 KB, a.D, lane);
}

// ---- launch -------------------------------------------------------------

template <int Dp>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t sa = smem_dq_dp<Dp>(), sb = smem_dkdv_dp<Dp>();
  cudaError_t err = cudaFuncSetAttribute(
      fab_dq_kernel<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sa);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fab_dkdv_kernel<Dp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (err != cudaSuccess) return err;
  const dim3 block(NTHREADS);
  fab_dq_kernel<Dp><<<dim3((a.Lq + ROWS - 1) / ROWS, a.H, a.B), block, sa,
                      stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fab_dkdv_kernel<Dp><<<dim3(a.Lk / KB, a.H, a.B), block, sb, stream>>>(a);
  return cudaGetLastError();
}

// (dq kernel, dk/dv kernel) shared bytes of head width D; 0 past MAX_D
static void smem_bytes(int D, size_t* sa, size_t* sb) {
  *sa = *sb = 0;
  switch (padded_d(D)) {
#define CASE(DP) \
  case DP: *sa = smem_dq_dp<DP>(); *sb = smem_dkdv_dp<DP>(); break;
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)
#undef CASE
    default: break;
  }
}

extern "C" {

// The kernels' constants and shared-memory sizes, so the wrapper sizes and
// checks alike.
int fab_rows() { return ROWS; }
int fab_tile() { return TILE; }
int fab_key_block() { return KB; }
int fab_max_d() { return MAX_D; }
long long fab_smem_dq(int D) {
  size_t sa, sb;
  smem_bytes(D, &sa, &sb);
  return (long long)sa;
}
long long fab_smem_dkdv(int D) {
  size_t sa, sb;
  smem_bytes(D, &sa, &sb);
  return (long long)sb;
}

// Launch (a) then (b) on `stream`. Returns cudaGetLastError() after the
// launches (0 when both were accepted), or cudaErrorInvalidValue for
// arguments the kernels do not take. The wrapper has checked shapes, the
// bf16 type, contiguity and 16-byte alignment, and allocated dq, dk, dv and
// the (3, B, H, Lq) f32 stats scratch.
int fab_launch(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int B, int Lq,
               int Lk, int H, int D, int kv_valid, int causal, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Lk % KB || H < 1 || D < 8 ||
      D > MAX_D || D % 8 || kv_valid < 1 || kv_valid > Lk || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.stats = stats;
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

const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
