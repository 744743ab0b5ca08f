// Fused QKV self-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the two forward Pallas kernels of the JAX package, which compute
// one function in two orientations:
//   K1 `_attn_kernel`   causaldiffae_tpu/ops/attention_pallas.py:116-149
//   K3 `_attn_kernel_t` causaldiffae_tpu/ops/attention_pallas.py:280-305
// Per batch element b and head h, with d the head width:
//   q, k, v = qkv[b, :, h*3d + {0, d, 2d} : +d]       (head-major [q k v])
//   q, k   *= d^-1/4, rounded to bf16                   (attention_pallas.py:129-134)
//   s       = q k^T, fp32 accumulation
//   p       = softmax(s) in fp32
//   out[b, :, h*d : (h+1)*d] = bf16(p) v, fp32 accumulation, rounded to bf16
// and, when the caller asks for it (the training path), the row logsumexp
// lse[b, h, t] = m + log(l) in fp32, which the backward kernel reads instead
// of recomputing the row statistics. K1 has no such output (its VJP keeps
// only qkv, attention_pallas.py:406-409); the function is unchanged.
//
// What bounds it on an H100: at the training path's (B, T, H, d) =
// (128, 784, 4, 32) the two products are 4.0e10 FLOP (41 us at the bf16
// tensor-core peak), the 3.1e8 exponentials need 75 us on the exponential
// unit (16 per clock per SM), and the fp32 softmax arithmetic (max,
// subtract, sum, the bf16 packing) about as long again on the CUDA cores,
// against 6 MB of device memory traffic. It is bound by operations on three
// units, so the design keeps them all fed:
// - One block of one warpgroup (4 warps) per (64-query tile, head, batch
//   element); each warp owns 16 query rows. q_s stays in registers as the
//   A operand for the whole sweep.
// - K and V tiles of 64 keys stream through a ring of Ring<D>::FWD
//   shared-memory stages, copied by TMA (one thread starts a copy, an
//   mbarrier counts its bytes) from a 3-D tensor map over [B, T, 3C]: the
//   copy of the next tiles
//   overlaps the math on this one, rows past T arrive as zeros, and no
//   register or instruction is spent on addresses. The K tile is scaled to
//   bf16(k s) in place once per tile, then fenced for the async proxy.
// - Both products are wgmma (m64 x n x k16, A from registers, B from the
//   swizzled tile by descriptor): s = q_s k_s^T reads K K-major, and
//   o += bf16(p) v reads V MN-major from the same layout, so each B operand
//   is read from shared memory once per warpgroup, not once per warp.
// - Online softmax in fp32 registers (running max and sum per row),
//   normalised once at the end; bf16(p) is packed straight from the score
//   accumulators into the A fragments of the second product.
// - The output is written in place into [B, T, C] from registers. The row
//   strides of qkv and out are arguments, so a strided view of the token
//   axis is accepted; the channel axis must be contiguous.
// - d = 128 (the Pendulum's and the circuit's deep blocks): the Pendulum
//   training shape (32, 144, 4, 128) is a grid of 384 blocks, two waves at
//   the 2 blocks per SM that 3 ring stages (99 KB) and 170 registers allow.
//   With 2 stages (66.5 KB; a T = 144 sweep has 3 tiles) and the scores of
//   32 keys at a time (two softmax steps per tile: 16 score registers
//   instead of 32), the kernel holds 153 registers and 3 blocks per SM, and
//   the grid runs in one wave. The second half's P V product runs on while
//   the next K tile is scaled.
// A masked key (the tail of the last tile) gets score -inf; query rows past
// T are computed on zeros and not stored (their lse is, and stays unread).
//
// Plain C interface (built with nvcc, loaded with ctypes):
//   int cdae_attention_fwd(const void* qkv, void* out, void* lse, int B, int T,
//                          int H, int D, long long qkv_sb, long long qkv_st,
//                          long long out_sb, long long out_st, float scale,
//                          void* stream)
// Strides are in elements. `scale` is d^-1/4 already rounded to bf16. `lse`
// is null or fp32 [B, H, Tp] with Tp = T rounded up to 64. The function
// launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).
//   int cdae_attention_fwd_info(int D, int kernel, int* smem,
//                               int* blocks_per_sm)
// gives the kernel's (kernel 0) dynamic shared memory at head width D and
// the blocks per SM that it and the kernel's registers allow.

#include "hopper.cuh"

namespace cdae {
namespace {

// Keys per softmax step: a tile's 64, or at d = 128 two halves of 32, whose
// scores take 16 registers a thread where 64 keys take 32 (with 64, the
// kernel needs 170 registers and spills under the 168 of 3 blocks per SM).
template <int D>
struct FwdPlan {
  static constexpr int KEYS = D == 128 ? 32 : ROWS;
};

template <int D>
__device__ __forceinline__ void attention_fwd_body(
    const CUtensorMap& qkv_map, const bf16* __restrict__ qkv, bf16* __restrict__ out,
    float* __restrict__ lse, int T, long long qkv_sb, long long qkv_st, long long out_sb,
    long long out_st, float scale) {
  using L = Tile<D>;
  constexpr int KC = D / 16;                  // k16 steps of q k^T
  constexpr int KEYS = FwdPlan<D>::KEYS;      // keys per softmax step
  constexpr int NS = KEYS / 2;                // score accumulators per thread
  constexpr int STAGES = Ring<D>::FWD;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  unsigned char* smem = align_1024(smem_raw);
  auto k_tile = [&](int stage) { return smem + stage * 2 * L::BYTES; };
  auto v_tile = [&](int stage) { return smem + stage * 2 * L::BYTES + L::BYTES; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within a fragment
  const int t4 = lane & 3;  // column pair within a fragment
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ROWS + warp * 16 + g;  // rows row0 and row0 + 8
  const int num_tiles = (T + ROWS - 1) / ROWS;
  const int k_col = h * 3 * D + D, v_col = h * 3 * D + 2 * D;

  auto fetch = [&](int tile, int stage) {
    mbar_expect_tx(&full[stage], 2 * L::BYTES);
    tma_tile<D>(k_tile(stage), &qkv_map, &full[stage], k_col, tile * ROWS, b);
    tma_tile<D>(v_tile(stage), &qkv_map, &full[stage], v_col, tile * ROWS, b);
  };
  auto land = [&](int tile) {  // wait for a tile, then k -> bf16(k s) in place
    const int stage = tile % STAGES;
    mbar_wait(&full[stage], (tile / STAGES) & 1);
    scale_tile<D>(k_tile(stage), scale);
  };

  init_ring(full);
  if (tid == 0)
    for (int t = 0; t < STAGES && t < num_tiles; ++t) fetch(t, t);

  uint32_t qf[KC][4];
  a_frags_global<KC>(qf, qkv + b * qkv_sb + static_cast<long long>(h) * 3 * D, qkv_st, row0, T,
                     scale, t4);
  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows g, g + 8)
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  land(0);
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int stage = kt % STAGES;
    __syncthreads();  // tile kt is scaled; every read of tile kt - 1 is done
    if (tid == 0 && kt > 0 && kt - 1 + STAGES < num_tiles)
      fetch(kt - 1 + STAGES, (kt - 1) % STAGES);

#pragma unroll
    for (int part = 0; part < ROWS / KEYS; ++part) {
      const int key0 = kt * ROWS + part * KEYS;
      if (part > 0 && key0 >= T) break;  // a half past T: nothing to add
      float s[NS];
      mma_abt<D, KEYS>(s, qf, k_tile(stage) + part * KEYS * L::RB);
      mma_wait(s);
      if (key0 + KEYS > T) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (key0 + (i >> 2) * 8 + 2 * t4 + (i & 1) >= T) s[i] = -INFINITY;
      }

      // Online softmax: new row max over the 4 threads that share a row.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // The first keys of every tile are unmasked, so mx is finite here and
      // exp2(-inf) = 0 covers both the first step and the masked keys.
      float alpha[2], rowsum[2] = {0.f, 0.f}, mxl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
        mxl[r] = mx[r] * LOG2E;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = exp2f(fmaf(s[i], LOG2E, -mxl[(i >> 1) & 1]));
        rowsum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + rowsum[r];
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      uint32_t pf[KEYS / 16][4];
      acc_to_a<KEYS>(pf, s);
      mma_ab<D, KEYS>(acc, pf, v_tile(stage) + part * KEYS * L::RB);
      if constexpr (KEYS == ROWS) {
        mma_wait(acc);
      } else {  // the last half's product runs on while the next K tile is scaled
        mma_commit();
        if (part + 1 < ROWS / KEYS) mma_wait_pending<0>(acc);
      }
    }
    if (kt + 1 < num_tiles) land(kt + 1);
    if constexpr (KEYS != ROWS) mma_wait_pending<0>(acc);
  }

  // Normalise by the full row sum and store bf16 pairs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // lse [B, H, Tp] with Tp = gridDim.x * ROWS: every row of the tile.
  if (lse != nullptr && t4 == 0) {
    float* dst = lse + (static_cast<long long>(b) * gridDim.y + h) * gridDim.x * ROWS;
    dst[row0] = m[0] + logf(l[0]);
    dst[row0 + 8] = m[1] + logf(l[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    const float inv = 1.f / l[r];
    bf16* dst = out + b * out_sb + row * out_st + h * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_f32(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attention_fwd_kernel(__grid_constant__ const CUtensorMap qkv_map, const bf16* __restrict__ qkv,
                     bf16* __restrict__ out, float* __restrict__ lse, int T, long long qkv_sb,
                     long long qkv_st, long long out_sb, long long out_st, float scale) {
  attention_fwd_body<D>(qkv_map, qkv, out, lse, T, qkv_sb, qkv_st, out_sb, out_st, scale);
}

// d = 128: at the Pendulum training shape (32, 144, 4, 128) the grid holds
// 384 blocks; 3 per SM (396 on 132 SMs) run it in one wave. That takes at
// most 65536 / (3 * 128) = 170 registers a thread (168 as allocated) and
// 3 x 66.5 KB of shared memory (2 ring stages).
template <>
__global__ void __launch_bounds__(NUM_THREADS, 3)
attention_fwd_kernel<128>(__grid_constant__ const CUtensorMap qkv_map,
                          const bf16* __restrict__ qkv, bf16* __restrict__ out,
                          float* __restrict__ lse, int T, long long qkv_sb, long long qkv_st,
                          long long out_sb, long long out_st, float scale) {
  attention_fwd_body<128>(qkv_map, qkv, out, lse, T, qkv_sb, qkv_st, out_sb, out_st, scale);
}

template <int D>
constexpr int fwd_smem() {
  return ring_smem(Ring<D>::FWD, 2 * Tile<D>::BYTES);  // a K and a V tile per stage
}

template <int D>
cudaError_t launch(const void* qkv, void* out, void* lse, int B, int T, int H, long long qkv_sb,
                   long long qkv_st, long long out_sb, long long out_st, float scale,
                   cudaStream_t stream) {
  CUtensorMap map;
  if (!make_tile_map<D>(&map, qkv, 3 * H * D, T, B, qkv_st, qkv_sb))
    return cudaErrorInvalidValue;
  constexpr int SMEM = fwd_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  attention_fwd_kernel<D><<<grid, NUM_THREADS, SMEM, stream>>>(
      map, static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<float*>(lse), T,
      qkv_sb, qkv_st, out_sb, out_st, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* smem, int* blocks_per_sm) {
  *smem = fwd_smem<D>();
  return kernel_occupancy(attention_fwd_kernel<D>, *smem, blocks_per_sm);
}

}  // namespace
}  // namespace cdae

extern "C" int cdae_attention_fwd(const void* qkv, void* out, void* lse, int B, int T, int H,
                                  int D, long long qkv_sb, long long qkv_st, long long out_sb,
                                  long long out_st, float scale, void* stream) {
  using namespace cdae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qkv, out, lse, B, T, H, qkv_sb, qkv_st, out_sb, out_st, scale, s);
    case 64: return launch<64>(qkv, out, lse, B, T, H, qkv_sb, qkv_st, out_sb, out_st, scale, s);
    case 128: return launch<128>(qkv, out, lse, B, T, H, qkv_sb, qkv_st, out_sb, out_st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel's dynamic shared memory at head width D and the blocks per SM
// that it and the kernel's registers allow (the build report's numbers).
extern "C" int cdae_attention_fwd_info(int D, int kernel, int* smem, int* blocks_per_sm) {
  using namespace cdae;
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return info<32>(smem, blocks_per_sm);
    case 64: return info<64>(smem, blocks_per_sm);
    case 128: return info<128>(smem, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
