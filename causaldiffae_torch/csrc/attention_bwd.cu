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
//   D   = rowsum(dp o p)                              fp32, from its definition
//   ds  = p o (dp - D)                                fp32
//   dq  = bf16(ds) k_s * s,  dk = bf16(ds)^T q_s * s  fp32 accumulation
// and each of dq, dk, dv is rounded to bf16 once, at its store into its
// lanes of dqkv [B, T, 3C] (the head-major [q k v] interleave of qkv).
//
// Design: the T x T matrices never leave registers (a flash-style backward),
// in two kernels with no atomics, so the result is deterministic:
//   (a) `dq` kernel, one block of 4 warps per (64-query tile, head, batch
//       element), each warp owning 16 query rows. Pass 1 streams the key
//       tiles and keeps, online, the row max m, the row sum l and the sum
//       D of p o dp, both rescaled whenever m moves; it writes
//       lse = m + log(l) and D = D / l to fp32 scratch [B, H, T]. Pass 2
//       streams the key tiles again, recomputes p = exp(s - lse) and
//       ds = p o (dp - D), and accumulates dq = bf16(ds) k_s.
//   (b) `dkv` kernel, one block per (64-key tile, head, batch element),
//       each warp owning 16 keys. It streams the query tiles, computes the
//       scores key-major (s^T = k_s q_s^T, dp^T = v g^T), recomputes
//       p^T from lse and ds^T from D, and accumulates dv += bf16(p^T) g and
//       dk += bf16(ds^T) q_s. Key-major, bf16(p^T) and bf16(ds^T) sit in the
//       accumulator layout the next mma takes as its A operand, the register
//       reuse the forward kernel uses for p.v, with no shared-memory round
//       trip.
// dq is written by (a) and dk, dv by (b) into disjoint lanes of dqkv, so
// nothing needs zero-filling; (b) runs after (a) on the same stream and reads
// its lse and D. g is read in place from [B, T, C].
//
// What bounds it on an H100: at the training path's (B, T, H, d) =
// (128, 784, 4, 32) the gradient needs 10 B H T^2 d = 1.0e11 FLOP of bf16
// products (~102 us at the tensor cores' peak) against ~180 MB of traffic
// (~54 us), plus 3.1e8 exponentials (~75 us on the exponential unit), so it
// is bound by operations. This first version is the simple right one: it
// recomputes the scores three times (twice in (a), once in (b)), uses
// mma.sync with synchronous tile loads, and gathers the B operands of the
// second products with 16-bit shared-memory loads. Tails (T % 64) are
// masked: in (a) a masked key's score is -inf, in (b) a masked query's p is
// 0; masked Q, G, K and V rows are zero-filled, since 0 x garbage can be NaN.
// Shared memory is dynamic (4 tiles of 64 x (d + 8) bf16 in (b): 70 KB at
// d = 128, above the 48 KB static limit), set with cudaFuncSetAttribute.
//
// Plain C interface (built with nvcc, loaded with ctypes):
//   int cdae_attention_bwd(const void* qkv, const void* g, void* dqkv,
//                          void* lse, void* dsum, int B, int T, int H, int D,
//                          long long qkv_sb, long long qkv_st,
//                          long long g_sb, long long g_st,
//                          long long dqkv_sb, long long dqkv_st,
//                          float scale, void* stream)
// Strides are in elements; lse and dsum are fp32 scratch of B*H*T each.
// `scale` is d^-1/4 already rounded to bf16. The function launches both
// kernels on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;  // rows per block (4 warps x 16) and per streamed tile
constexpr int NUM_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// bf16(x * scale) for a pair, the rounding of a bf16 x bf16 product.
__device__ __forceinline__ __nv_bfloat162 scale_pair(__nv_bfloat162 v, float scale) {
  float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(f.x * scale, f.y * scale);
}

__device__ __forceinline__ uint4 scale_vec(uint4 v, float scale) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = scale_pair(p[i], scale);
  return v;
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A[r]: row g + (r & 1) * 8, columns (r >> 1) * 8 + 2 t4 and +1;
//   B[r]: rows (k) r * 8 + 2 t4 and +1, column (n) g;
//   C[e]: row g + (e >> 1) * 8, column 2 t4 + (e & 1).

// A fragment of a padded shared tile: rows r0.., columns c0.. (16 x 16).
template <int LDS>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile, int r0, int c0,
                                       int g, int t4) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = *reinterpret_cast<const uint32_t*>(
        &tile[(r0 + g + (r & 1) * 8) * LDS + c0 + (r >> 1) * 8 + 2 * t4]);
}

// B fragment with B[k][n] = tile[n0 + n][c0 + k]: the tile's rows are the
// output columns (the k^T of q k^T).
template <int LDS>
__device__ __forceinline__ void b_frag_rows(uint32_t (&b)[2], const bf16* tile, int n0, int c0,
                                            int g, int t4) {
  const bf16* p = &tile[(n0 + g) * LDS + c0 + 2 * t4];
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = tile[k0 + k][c0 + n]: the tile's rows are the
// contraction (the v of p v), gathered with 16-bit loads.
template <int LDS>
__device__ __forceinline__ void b_frag_cols(uint32_t (&b)[2], const bf16* tile, int k0, int c0,
                                            int g, int t4) {
  const int kr = k0 + 2 * t4;
  const int col = c0 + g;
  b[0] = pack_bf16(tile[kr * LDS + col], tile[(kr + 1) * LDS + col]);
  b[1] = pack_bf16(tile[(kr + 8) * LDS + col], tile[(kr + 9) * LDS + col]);
}

// Copy rows row0.. (TILE of them) of two D-wide sources into padded shared
// tiles: `a` scaled by `scale_a` (1 = unscaled), `b` as it is. Rows at or
// past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tiles(bf16* as, bf16* bs, const bf16* a, const bf16* b,
                                           long long a_st, long long b_st, int row0, int T,
                                           float scale_a, bool scale) {
  constexpr int LDS = D + 8;
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < TILE * VEC; idx += NUM_THREADS) {
    const int r = idx / VEC;
    const int cv = idx % VEC;
    const int row = row0 + r;
    uint4 av = make_uint4(0, 0, 0, 0);
    uint4 bv = make_uint4(0, 0, 0, 0);
    if (row < T) {
      av = *reinterpret_cast<const uint4*>(a + row * a_st + cv * 8);
      if (scale) av = scale_vec(av, scale_a);
      bv = *reinterpret_cast<const uint4*>(b + row * b_st + cv * 8);
    }
    *reinterpret_cast<uint4*>(&as[r * LDS + cv * 8]) = av;
    *reinterpret_cast<uint4*>(&bs[r * LDS + cv * 8]) = bv;
  }
}

// A fragments of this warp's 16 rows straight from device memory (Q or G),
// optionally scaled; rows at or past T are zero.
template <int KC>
__device__ __forceinline__ void a_frags_global(uint32_t (&f)[KC][4], const bf16* src,
                                               long long st, int row0, int T, float scale,
                                               bool do_scale, int t4) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = kc * 16 + (r >> 1) * 8 + 2 * t4;
      uint32_t v = 0;
      if (row < T) {
        __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(src + row * st + col);
        if (do_scale) pair = scale_pair(pair, scale);
        v = *reinterpret_cast<uint32_t*>(&pair);
      }
      f[kc][r] = v;
    }
  }
}

// s = A B^T for this warp's 16 rows and a tile's 64 rows (A from registers).
template <int KC, int LDS>
__device__ __forceinline__ void scores(float (&s)[TILE / 8][4], const uint32_t (&af)[KC][4],
                                       const bf16* tile, int g, int t4) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t bfr[2];
      b_frag_rows<LDS>(bfr, tile, j * 8, kc * 16, g, t4);
      mma_16816(s[j], af[kc], bfr);
    }
  }
}

// (a): dq, and the row statistics lse and D.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                        bf16* __restrict__ dqkv, float* __restrict__ lse_out,
                        float* __restrict__ dsum_out, int T, int H, long long qkv_sb,
                        long long qkv_st, long long g_sb, long long g_st, long long d_sb,
                        long long d_st, float scale) {
  constexpr int KC = D / 16;      // 16-wide chunks of the head dim
  constexpr int DN = D / 8;       // 8-wide output tiles of the head dim
  constexpr int NT = TILE / 8;    // 8-key score tiles per key tile
  constexpr int LDS = D + 8;      // padded shared row: conflict-free fragment loads

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * LDS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* head = qkv + b * qkv_sb + static_cast<long long>(h) * 3 * D;
  const bf16* gh = gout + b * g_sb + static_cast<long long>(h) * D;
  const int row0 = blockIdx.x * TILE + warp * 16 + g;  // rows row0 and row0 + 8

  uint32_t qf[KC][4], gf[KC][4];
  a_frags_global<KC>(qf, head, qkv_st, row0, T, scale, true, t4);
  a_frags_global<KC>(gf, gh, g_st, row0, T, 1.f, false, t4);

  const int num_tiles = (T + TILE - 1) / TILE;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows g, g + 8)
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float dacc[2] = {0.f, 0.f};           // this thread's part of sum p dp

  // Pass 1: online row max, row sum and D.
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int key0 = kt * TILE;
    __syncthreads();  // the previous tile's reads are done
    load_tiles<D>(Ks, Vs, head + D, head + 2 * D, qkv_st, qkv_st, key0, T, scale, true);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    scores<KC, LDS>(s, qf, Ks, g, t4);
    scores<KC, LDS>(dp, gf, Vs, g, t4);
    if (key0 + TILE > T) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * t4 + (e & 1) >= T) s[j][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // Every tile holds at least one unmasked key, so mx is finite here and
    // exp2(-inf) = 0 covers both the first tile and the masked keys.
    float rowsum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - mx[e >> 1]) * LOG2E);
        rowsum[e >> 1] += p;
        dsum[e >> 1] += p * dp[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = exp2f((m[r] - mx[r]) * LOG2E);
      l[r] = l[r] * alpha + rowsum[r];
      dacc[r] = dacc[r] * alpha + dsum[r];
      m[r] = mx[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    dacc[r] += __shfl_xor_sync(0xffffffffu, dacc[r], 1);
    dacc[r] += __shfl_xor_sync(0xffffffffu, dacc[r], 2);
  }
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = m[r] + logf(l[r]);
    dd[r] = dacc[r] / l[r];
    const int row = row0 + r * 8;
    if (t4 == 0 && row < T) {
      const long long idx = (static_cast<long long>(b) * H + h) * T + row;
      lse_out[idx] = lse[r];
      dsum_out[idx] = dd[r];
    }
  }

  // Pass 2: dq = bf16(ds) k_s.
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int key0 = kt * TILE;
    __syncthreads();
    load_tiles<D>(Ks, Vs, head + D, head + 2 * D, qkv_st, qkv_st, key0, T, scale, true);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    scores<KC, LDS>(s, qf, Ks, g, t4);
    scores<KC, LDS>(dp, gf, Vs, g, t4);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool masked = key0 + j * 8 + 2 * t4 + (e & 1) >= T;
        const float p = masked ? 0.f : exp2f((s[j][e] - lse[e >> 1]) * LOG2E);
        s[j][e] = p * (dp[j][e] - dd[e >> 1]);  // ds
      }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t da[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t kb[2];
        b_frag_cols<LDS>(kb, Ks, kk * 16, dn * 8, g, t4);
        mma_16816(acc[dn], da, kb);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    bf16* dst = dqkv + b * d_sb + row * d_st + static_cast<long long>(h) * 3 * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8) =
          pack_f32(acc[dn][2 * r] * scale, acc[dn][2 * r + 1] * scale);
  }
}

// (b): dk and dv, key-major, from the lse and D that (a) wrote.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                         bf16* __restrict__ dqkv, const float* __restrict__ lse_in,
                         const float* __restrict__ dsum_in, int T, int H, long long qkv_sb,
                         long long qkv_st, long long g_sb, long long g_st, long long d_sb,
                         long long d_st, float scale) {
  constexpr int KC = D / 16;
  constexpr int DN = D / 8;
  constexpr int NT = TILE / 8;    // 8-query score tiles per query tile
  constexpr int LDS = D + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * LDS;
  bf16* Qs = Vs + TILE * LDS;
  bf16* Gs = Qs + TILE * LDS;
  float* Ls = reinterpret_cast<float*>(Gs + TILE * LDS);
  float* Ds = Ls + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* head = qkv + b * qkv_sb + static_cast<long long>(h) * 3 * D;
  const bf16* gh = gout + b * g_sb + static_cast<long long>(h) * D;
  const long long bh = (static_cast<long long>(b) * H + h) * T;
  const int key0 = blockIdx.x * TILE;
  const int wrow = warp * 16;  // this warp's first key within the tile

  // The block's keys, scaled, and values; read by every query tile.
  load_tiles<D>(Ks, Vs, head + D, head + 2 * D, qkv_st, qkv_st, key0, T, scale, true);

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  const int num_tiles = (T + TILE - 1) / TILE;
  for (int qt = 0; qt < num_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // the previous tile's reads are done
    load_tiles<D>(Qs, Gs, head, gh, qkv_st, g_st, q0, T, scale, true);
    if (tid < TILE) {
      const bool in = q0 + tid < T;
      Ls[tid] = in ? lse_in[bh + q0 + tid] : 0.f;
      Ds[tid] = in ? dsum_in[bh + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T = k_s q_s^T and dp^T = v g^T for this warp's 16 keys.
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      a_frag<LDS>(ka, Ks, wrow, kc * 16, g, t4);
      a_frag<LDS>(va, Vs, wrow, kc * 16, g, t4);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bq[2], bg[2];
        b_frag_rows<LDS>(bq, Qs, j * 8, kc * 16, g, t4);
        b_frag_rows<LDS>(bg, Gs, j * 8, kc * 16, g, t4);
        mma_16816(st[j], ka, bq);
        mma_16816(dpt[j], va, bg);
      }
    }
    // p^T and ds^T; a masked query contributes nothing.
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        const float p = q0 + col < T ? exp2f((st[j][e] - Ls[col]) * LOG2E) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - Ds[col]);
      }
    // dv += bf16(p^T) g and dk += bf16(ds^T) q_s: 16 queries per A fragment.
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(st[2 * kk][0], st[2 * kk][1]),
                              pack_f32(st[2 * kk][2], st[2 * kk][3]),
                              pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_f32(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_f32(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_f32(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_f32(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t bg[2], bq[2];
        b_frag_cols<LDS>(bg, Gs, kk * 16, dn * 8, g, t4);
        b_frag_cols<LDS>(bq, Qs, kk * 16, dn * 8, g, t4);
        mma_16816(dv[dn], pa, bg);
        mma_16816(dk[dn], da, bq);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + wrow + g + r * 8;
    if (key >= T) continue;
    bf16* dst = dqkv + b * d_sb + key * d_st + static_cast<long long>(h) * 3 * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<uint32_t*>(dst + D + dn * 8) =
          pack_f32(dk[dn][2 * r] * scale, dk[dn][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dst + 2 * D + dn * 8) =
          pack_f32(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, void* lse, void* dsum, int B,
                   int T, int H, long long qkv_sb, long long qkv_st, long long g_sb,
                   long long g_st, long long d_sb, long long d_st, float scale,
                   cudaStream_t stream) {
  constexpr int LDS = D + 8;
  constexpr int SMEM_DQ = 2 * TILE * LDS * sizeof(bf16);
  constexpr int SMEM_DKV = 4 * TILE * LDS * sizeof(bf16) + 2 * TILE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TILE - 1) / TILE, H, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* go = static_cast<const bf16*>(g);
  bf16* dq = static_cast<bf16*>(dqkv);
  attention_bwd_dq_kernel<D><<<grid, NUM_THREADS, SMEM_DQ, stream>>>(
      q, go, dq, static_cast<float*>(lse), static_cast<float*>(dsum), T, H, qkv_sb, qkv_st,
      g_sb, g_st, d_sb, d_st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<D><<<grid, NUM_THREADS, SMEM_DKV, stream>>>(
      q, go, dq, static_cast<const float*>(lse), static_cast<const float*>(dsum), T, H, qkv_sb,
      qkv_st, g_sb, g_st, d_sb, d_st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cdae_attention_bwd(const void* qkv, const void* g, void* dqkv, void* lse,
                                  void* dsum, int B, int T, int H, int D, long long qkv_sb,
                                  long long qkv_st, long long g_sb, long long g_st,
                                  long long dqkv_sb, long long dqkv_st, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32>(qkv, g, dqkv, lse, dsum, B, T, H, qkv_sb, qkv_st, g_sb, g_st, dqkv_sb,
                       dqkv_st, scale, s);
      break;
    case 64:
      err = launch<64>(qkv, g, dqkv, lse, dsum, B, T, H, qkv_sb, qkv_st, g_sb, g_st, dqkv_sb,
                       dqkv_st, scale, s);
      break;
    case 128:
      err = launch<128>(qkv, g, dqkv, lse, dsum, B, T, H, qkv_sb, qkv_st, g_sb, g_st, dqkv_sb,
                        dqkv_st, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
