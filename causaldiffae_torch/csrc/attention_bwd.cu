// Fused QKV self-attention backward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the two backward Pallas kernels of the JAX package, which compute
// one gradient in two orientations (the custom VJPs of the two forward
// entries, attention_pallas.py:402-442):
//   K2 `_attn_bwd_kernel`   causaldiffae_tpu/ops/attention_pallas.py:184-248
//   K4 `_attn_bwd_kernel_t` causaldiffae_tpu/ops/attention_pallas.py:308-381
// Per batch element b and head h, with d the head width, s = bf16(d^-1/4):
//   q_s, k_s = bf16(q s), bf16(k s)                  (attention_pallas.py:206-211)
//   p   = softmax(q_s k_s^T), fp32, normalised
//   dv  = bf16(p)^T g                                 fp32 accumulation
//   dp  = g v^T                                       fp32
//   D   = rowsum(dp o p)                              fp32
//   ds  = p o (dp - D)                                fp32
//   dq  = bf16(ds) k_s * s,  dk = bf16(ds)^T q_s * s  fp32 accumulation
// and each of dq, dk, dv is rounded to bf16 once, at its store into its
// lanes of dqkv [B, T, 3C] (the head-major [q k v] interleave of qkv).
//
// Where K2 recomputes the row statistics from qkv, this kernel reads them:
// p = exp(s - lse) with lse the forward kernel's row logsumexp, and
// D = rowsum(g o) with o the forward's bf16 output, which equals
// rowsum(dp o p) up to the rounding of o (2^-9 of the D term of the
// rounding scale M, far inside the kernel's 2^-6 M bound). The function is
// K2's; only the residuals differ (K2 keeps qkv alone, :406-409).
//
// What bounds it on an H100: at the training path's (B, T, H, d) =
// (128, 784, 4, 32) the gradient needs 5 T x T products, 1.0e11 FLOP (102 us
// at the bf16 tensor-core peak); this design runs 7 (s and dp twice, once
// per kernel), 1.4e11 FLOP, and 2 exponentials per score, 6.3e8 (150 us on
// the exponential unit), against ~180 MB of device memory traffic (54 us).
// It is bound by operations. The design:
// - Two kernels, no atomics, so the result is deterministic:
//   (a) `dq`, one block of one warpgroup per (64-query tile, head, batch
//       element), each warp owning 16 query rows. Its prologue reads lse,
//       forms D from g and o and writes it to fp32 scratch [B, H, Tp]; then
//       ONE sweep over the key tiles: s = q_s k_s^T and dp = g v^T,
//       p = exp(s - lse), ds = p o (dp - D), dq += bf16(ds) k_s.
//   (b) `dkv`, one block per (64-key tile, head, batch element), key-major:
//       it sweeps the query tiles, s^T = k_s q_s^T, dp^T = v g^T, p^T from
//       lse, ds^T from D, dv += bf16(p^T) g, dk += bf16(ds^T) q_s. Key-major,
//       bf16(p^T) and bf16(ds^T) come out of the accumulators in the layout
//       the next product takes as its A operand, with no shared-memory
//       round trip.
//   dq is written by (a) and dk, dv by (b) into disjoint lanes of dqkv; (b)
//   runs after (a) on the same stream and reads its D.
// - The A operands (q_s and g in (a), k_s and v in (b)) stay in registers
//   for the whole sweep. The streamed tiles (K and V in (a); Q, G and the
//   tile's 64 lse and D values in (b)) flow through a ring of STAGES
//   shared-memory stages by TMA from 3-D tensor maps over [B, T, width]
//   (rows past T arrive as zeros, no tile reads the next batch element),
//   so the next tiles' copies overlap this tile's math. The K tile in (a)
//   and the Q tile in (b) are scaled to bf16(x s) in place once per tile,
//   then fenced for the async proxy.
// - All four products of a tile are wgmma (A from registers, B from the
//   swizzled tile by descriptor): the tile is read K-major for s and dp and
//   MN-major for dq (dk, dv), each B operand once per warpgroup.
// - Tails: in (a) a masked key's p is 0 (its zero-filled k gives s = 0, its
//   zero v gives dp = 0, so ds would not be); in (b) a masked query's p is 0.
// - Shared memory is dynamic (3 stages of two tiles: 99 KB at d = 128),
//   set with cudaFuncSetAttribute.
//
// Plain C interface (built with nvcc, loaded with ctypes):
//   int cdae_attention_bwd(const void* qkv, const void* g, const void* out,
//                          const void* lse, void* dqkv, void* dsum, int B,
//                          int T, int H, int D, long long qkv_sb,
//                          long long qkv_st, long long g_sb, long long g_st,
//                          long long out_sb, long long out_st,
//                          long long dqkv_sb, long long dqkv_st, float scale,
//                          void* stream)
// Strides are in elements; lse (the forward kernel's) and dsum (scratch) are
// fp32 [B, H, Tp] with Tp = T rounded up to 64; g and out [B, T, C] bf16
// with a contiguous channel axis. `scale` is d^-1/4 already rounded to
// bf16. The function launches both kernels on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "hopper.cuh"

namespace cdae {
namespace {

// (a): dq in one sweep over the keys; writes D.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attention_bwd_dq_kernel(__grid_constant__ const CUtensorMap qkv_map, const bf16* __restrict__ qkv,
                        const bf16* __restrict__ gout, const bf16* __restrict__ out,
                        const float* __restrict__ lse_in, bf16* __restrict__ dqkv,
                        float* __restrict__ dsum_out, int T, int H, long long qkv_sb,
                        long long qkv_st, long long g_sb, long long g_st, long long o_sb,
                        long long o_st, long long d_sb, long long d_st, float scale) {
  using L = Tile<D>;
  constexpr int KC = D / 16;
  constexpr int NS = ROWS / 2;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* smem = align_1024(smem_raw);
  auto k_tile = [&](int stage) { return smem + stage * 2 * L::BYTES; };
  auto v_tile = [&](int stage) { return smem + stage * 2 * L::BYTES + L::BYTES; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROWS + warp * 16 + g;  // rows row0 and row0 + 8
  const long long stat0 = (static_cast<long long>(b) * H + h) * gridDim.x * ROWS;
  const int num_tiles = (T + ROWS - 1) / ROWS;
  const int k_col = h * 3 * D + D, v_col = h * 3 * D + 2 * D;

  auto fetch = [&](int tile, int stage) {
    mbar_expect_tx(&full[stage], 2 * L::BYTES);
    tma_tile<D>(k_tile(stage), &qkv_map, &full[stage], k_col, tile * ROWS, b);
    tma_tile<D>(v_tile(stage), &qkv_map, &full[stage], v_col, tile * ROWS, b);
  };
  auto land = [&](int tile) {
    const int stage = tile % STAGES;
    mbar_wait(&full[stage], (tile / STAGES) & 1);
    scale_tile<D>(k_tile(stage), scale);
  };

  init_ring(full);
  if (tid == 0)
    for (int t = 0; t < STAGES && t < num_tiles; ++t) fetch(t, t);

  uint32_t qf[KC][4], gf[KC][4];
  a_frags_global<KC>(qf, qkv + b * qkv_sb + static_cast<long long>(h) * 3 * D, qkv_st, row0, T,
                     scale, t4);
  a_frags_global<KC>(gf, gout + b * g_sb + static_cast<long long>(h) * D, g_st, row0, T, 1.f, t4);

  // D = rowsum(g o) over the quad's fragment columns; lse (base 2) from the forward.
  const bf16* oh = out + b * o_sb + static_cast<long long>(h) * D;
  float lse2[2], dd[2] = {0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      if (row >= T) continue;
      const uint32_t o = *reinterpret_cast<const uint32_t*>(
          oh + row * o_st + kc * 16 + (r >> 1) * 8 + 2 * t4);
      dd[r & 1] += bf16_lo(gf[kc][r]) * bf16_lo(o) + bf16_hi(gf[kc][r]) * bf16_hi(o);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
    lse2[r] = lse_in[stat0 + row0 + r * 8] * LOG2E;
    if (t4 == 0) dsum_out[stat0 + row0 + r * 8] = dd[r];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  land(0);
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int stage = kt % STAGES;
    const int key0 = kt * ROWS;
    __syncthreads();  // tile kt is scaled; every read of tile kt - 1 is done
    if (tid == 0 && kt > 0 && kt - 1 + STAGES < num_tiles)
      fetch(kt - 1 + STAGES, (kt - 1) % STAGES);

    float s[NS], dp[NS];
    mma_abt<D>(s, qf, k_tile(stage));
    mma_abt<D>(dp, gf, v_tile(stage));
    mma_wait(s, dp);
    const bool tail = key0 + ROWS > T;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], LOG2E, -lse2[r]));
      if (tail && key0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= T) p = 0.f;
      s[i] = p * (dp[i] - dd[r]);  // ds
    }
    uint32_t dsf[ROWS / 16][4];
    acc_to_a<ROWS>(dsf, s);
    mma_ab<D>(acc, dsf, k_tile(stage));
    mma_wait(acc);
    if (kt + 1 < num_tiles) land(kt + 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    bf16* dst = dqkv + b * d_sb + row * d_st + static_cast<long long>(h) * 3 * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_f32(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// (b): dk and dv, key-major, from lse and the D that (a) wrote.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attention_bwd_dkv_kernel(__grid_constant__ const CUtensorMap qkv_map,
                         __grid_constant__ const CUtensorMap g_map, const bf16* __restrict__ qkv,
                         const float* __restrict__ lse_in, const float* __restrict__ dsum_in,
                         bf16* __restrict__ dqkv, int T, int H, long long qkv_sb,
                         long long qkv_st, long long d_sb, long long d_st, float scale) {
  using L = Tile<D>;
  constexpr int KC = D / 16;
  constexpr int NS = ROWS / 2;
  constexpr int STATS = 2 * ROWS * sizeof(float);  // a tile's lse and D

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* smem = align_1024(smem_raw);
  auto q_tile = [&](int stage) { return smem + stage * 2 * L::BYTES; };
  auto g_tile = [&](int stage) { return smem + stage * 2 * L::BYTES + L::BYTES; };
  auto stats = [&](int stage) {
    return reinterpret_cast<float*>(smem + STAGES * 2 * L::BYTES + stage * STATS);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key_row0 = blockIdx.x * ROWS + warp * 16 + g;  // keys key_row0 and key_row0 + 8
  const long long stat0 = (static_cast<long long>(b) * H + h) * gridDim.x * ROWS;
  const int num_tiles = (T + ROWS - 1) / ROWS;
  const int q_col = h * 3 * D, g_col = h * D;

  auto fetch = [&](int tile, int stage) {
    mbar_expect_tx(&full[stage], 2 * L::BYTES + STATS);
    tma_tile<D>(q_tile(stage), &qkv_map, &full[stage], q_col, tile * ROWS, b);
    tma_tile<D>(g_tile(stage), &g_map, &full[stage], g_col, tile * ROWS, b);
    bulk_load(stats(stage), lse_in + stat0 + tile * ROWS, STATS / 2, &full[stage]);
    bulk_load(stats(stage) + ROWS, dsum_in + stat0 + tile * ROWS, STATS / 2, &full[stage]);
  };
  auto land = [&](int tile) {
    const int stage = tile % STAGES;
    mbar_wait(&full[stage], (tile / STAGES) & 1);
    scale_tile<D>(q_tile(stage), scale);
  };

  init_ring(full);
  if (tid == 0)
    for (int t = 0; t < STAGES && t < num_tiles; ++t) fetch(t, t);

  const bf16* head = qkv + b * qkv_sb + static_cast<long long>(h) * 3 * D;
  uint32_t kf[KC][4], vf[KC][4];
  a_frags_global<KC>(kf, head + D, qkv_st, key_row0, T, scale, t4);
  a_frags_global<KC>(vf, head + 2 * D, qkv_st, key_row0, T, 1.f, t4);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  land(0);
  for (int qt = 0; qt < num_tiles; ++qt) {
    const int stage = qt % STAGES;
    const int q0 = qt * ROWS;
    __syncthreads();  // tile qt is scaled; every read of tile qt - 1 is done
    if (tid == 0 && qt > 0 && qt - 1 + STAGES < num_tiles)
      fetch(qt - 1 + STAGES, (qt - 1) % STAGES);

    float st[NS], dpt[NS];
    mma_abt<D>(st, kf, q_tile(stage));
    mma_abt<D>(dpt, vf, g_tile(stage));
    mma_wait(st, dpt);
    // p^T and ds^T; a masked query contributes nothing.
    const float* ls = stats(stage);
    const bool tail = q0 + ROWS > T;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
      const int col = j * 8 + 2 * t4;
      const float2 lse = *reinterpret_cast<const float2*>(ls + col);
      const float2 dsum = *reinterpret_cast<const float2*>(ls + ROWS + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2f(fmaf(st[i], LOG2E, -(e & 1 ? lse.y : lse.x) * LOG2E));
        if (tail && q0 + col + (e & 1) >= T) p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - (e & 1 ? dsum.y : dsum.x));
      }
    }
    uint32_t pf[ROWS / 16][4], dsf[ROWS / 16][4];
    acc_to_a<ROWS>(pf, st);
    acc_to_a<ROWS>(dsf, dpt);
    mma_ab<D>(dv, pf, g_tile(stage));
    mma_ab<D>(dk, dsf, q_tile(stage));
    mma_wait(dv, dk);
    if (qt + 1 < num_tiles) land(qt + 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_row0 + r * 8;
    if (key >= T) continue;
    bf16* dst = dqkv + b * d_sb + key * d_st + static_cast<long long>(h) * 3 * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + D + j * 8) =
          pack_f32(dk[4 * j + 2 * r] * scale, dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dst + 2 * D + j * 8) =
          pack_f32(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, const void* g, const void* out, const void* lse, void* dqkv,
                   void* dsum, int B, int T, int H, long long qkv_sb, long long qkv_st,
                   long long g_sb, long long g_st, long long o_sb, long long o_st,
                   long long d_sb, long long d_st, float scale, cudaStream_t stream) {
  CUtensorMap qkv_map, g_map;
  if (!make_tile_map<D>(&qkv_map, qkv, 3 * H * D, T, B, qkv_st, qkv_sb) ||
      !make_tile_map<D>(&g_map, g, H * D, T, B, g_st, g_sb))
    return cudaErrorInvalidValue;
  constexpr int SMEM_DQ = STAGES * 2 * Tile<D>::BYTES + 1024;
  constexpr int SMEM_DKV = SMEM_DQ + STAGES * 2 * ROWS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  attention_bwd_dq_kernel<D><<<grid, NUM_THREADS, SMEM_DQ, stream>>>(
      qkv_map, q, static_cast<const bf16*>(g), static_cast<const bf16*>(out),
      static_cast<const float*>(lse), dq, static_cast<float*>(dsum), T, H, qkv_sb, qkv_st, g_sb,
      g_st, o_sb, o_st, d_sb, d_st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<D><<<grid, NUM_THREADS, SMEM_DKV, stream>>>(
      qkv_map, g_map, q, static_cast<const float*>(lse), static_cast<const float*>(dsum), dq, T,
      H, qkv_sb, qkv_st, d_sb, d_st, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cdae

extern "C" int cdae_attention_bwd(const void* qkv, const void* g, const void* out,
                                  const void* lse, void* dqkv, void* dsum, int B, int T, int H,
                                  int D, long long qkv_sb, long long qkv_st, long long g_sb,
                                  long long g_st, long long out_sb, long long out_st,
                                  long long dqkv_sb, long long dqkv_st, float scale,
                                  void* stream) {
  using namespace cdae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CDAE_BWD(DD)                                                                         \
  launch<DD>(qkv, g, out, lse, dqkv, dsum, B, T, H, qkv_sb, qkv_st, g_sb, g_st, out_sb, out_st, \
             dqkv_sb, dqkv_st, scale, s)
  switch (D) {
    case 32: return CDAE_BWD(32);
    case 64: return CDAE_BWD(64);
    case 128: return CDAE_BWD(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CDAE_BWD
}
