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
//
// Design: a flash-style forward. One block of 4 warps per (query tile of 64,
// head, batch element); each warp owns 16 query rows. The block streams
// 64-key tiles of K and V through shared memory and keeps a running max and
// sum per row in fp32 (online softmax), normalising once at the end, so the
// T x T scores never leave registers. Both products run on the tensor cores
// with mma.sync.m16n8k16 (bf16 operands, fp32 accumulators); the score
// accumulators are rounded to bf16 in registers and reused directly as the
// A operand of the P.V product. q, k and v are read in place from the
// [B, T, 3C] projection output, and the output is written in place into
// [B, T, C]: no transpose copy on either side. The row strides of both are
// arguments, so a strided view of the token axis is accepted; the channel
// axis must be contiguous.
//
// What bounds it on an H100: at the main path's T=784, d=32 the work per
// launch is about 5 GFLOP of bf16 products, 39 M exponentials and 12.8 MB of
// device memory traffic (B=16, 4 heads). The products alone need ~5 us at
// the tensor cores' peak, the traffic ~4 us, and the exponentials and the
// fp32 softmax arithmetic on the CUDA cores are of the same order, so the
// kernel sits near the ridge and is bound by operations, not bytes. This
// first version is the simple right one: K/V tiles are loaded synchronously
// (no cp.async/TMA double buffering), V's B fragments are gathered with
// 16-bit shared-memory loads, and mma.sync runs at a fraction of wgmma's
// rate. Query tails (T % 64) and key tails are masked: a masked key's score
// is -inf before the max, a masked query row is computed on zeros and not
// stored.
//
// Plain C interface (built with nvcc, loaded with ctypes):
//   int cdae_attention_fwd(const void* qkv, void* out, int B, int T, int H,
//                          int D, long long qkv_sb, long long qkv_st,
//                          long long out_sb, long long out_st, float scale,
//                          void* stream)
// Strides are in elements. `scale` is d^-1/4 already rounded to bf16. The
// function launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // queries per block: 4 warps x 16 rows
constexpr int BLOCK_N = 64;  // keys per shared-memory tile
constexpr int NUM_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                     int T, long long qkv_sb, long long qkv_st, long long out_sb,
                     long long out_st, float scale) {
  constexpr int KC = D / 16;       // 16-wide chunks of the head dim (Q.K^T depth)
  constexpr int DN = D / 8;        // 8-wide output tiles of the head dim (P.V)
  constexpr int NT = BLOCK_N / 8;  // 8-key score tiles per key tile
  constexpr int LDS = D + 8;       // padded shared row: conflict-free fragment loads
  constexpr int VEC = D / 8;       // 16-byte vectors per row

  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_N * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within an mma fragment
  const int t4 = lane & 3;  // column pair within an mma fragment
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* head = qkv + b * qkv_sb + static_cast<long long>(h) * 3 * D;
  const int row0 = blockIdx.x * BLOCK_M + warp * 16 + g;  // rows row0 and row0 + 8

  // Q fragments (A operand, row-major 16 x D), scaled and kept in registers.
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = kc * 16 + (r >> 1) * 8 + 2 * t4;
      uint32_t v = 0;
      if (row < T) {
        __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(head + row * qkv_st + col);
        pair = scale_pair(pair, scale);
        v = *reinterpret_cast<uint32_t*>(&pair);
      }
      qf[kc][r] = v;
    }
  }

  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows g, g + 8)
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int num_tiles = (T + BLOCK_N - 1) / BLOCK_N;
  for (int kt = 0; kt < num_tiles; ++kt) {
    const int key0 = kt * BLOCK_N;
    __syncthreads();  // the previous tile's reads are done
    for (int idx = tid; idx < BLOCK_N * VEC; idx += NUM_THREADS) {
      const int row = idx / VEC;
      const int cv = idx % VEC;
      const int key = key0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);  // masked V rows must be 0, not garbage
      if (key < T) {
        const __nv_bfloat16* src = head + key * qkv_st + cv * 8;
        kv = scale_vec(*reinterpret_cast<const uint4*>(src + D), scale);
        vv = *reinterpret_cast<const uint4*>(src + 2 * D);
      }
      *reinterpret_cast<uint4*>(&Ks[row * LDS + cv * 8]) = kv;
      *reinterpret_cast<uint4*>(&Vs[row * LDS + cv * 8]) = vv;
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kp = &Ks[(j * 8 + g) * LDS + kc * 16 + 2 * t4];
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                *reinterpret_cast<const uint32_t*>(kp + 8)};
        mma_16816(s[j], qf[kc], bf);
      }
    }
    if (key0 + BLOCK_N > T) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * t4 + (e & 1) >= T) s[j][e] = -INFINITY;
    }

    // Online softmax: new row max over the 4 threads that share a row.
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
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - mx[e >> 1]) * LOG2E);
        rowsum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rowsum[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];

    // acc += bf16(p) v: two adjacent 8-key score tiles form one A fragment.
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int kr = kk * 16 + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t vb[2] = {pack_bf16(Vs[kr * LDS + col], Vs[(kr + 1) * LDS + col]),
                                pack_bf16(Vs[(kr + 8) * LDS + col], Vs[(kr + 9) * LDS + col])};
        mma_16816(acc[dn], pa, vb);
      }
    }
  }

  // Normalise by the full row sum and store bf16 pairs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= T) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* dst = out + b * out_sb + row * out_st + h * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<uint32_t*>(dst + dn * 8) =
          pack_f32(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
  }
}

template <int D>
void launch(const void* qkv, void* out, int B, int T, int H, long long qkv_sb,
            long long qkv_st, long long out_sb, long long out_st, float scale,
            cudaStream_t stream) {
  const dim3 grid((T + BLOCK_M - 1) / BLOCK_M, H, B);
  attention_fwd_kernel<D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), T, qkv_sb,
      qkv_st, out_sb, out_st, scale);
}

}  // namespace

extern "C" int cdae_attention_fwd(const void* qkv, void* out, int B, int T, int H, int D,
                                  long long qkv_sb, long long qkv_st, long long out_sb,
                                  long long out_st, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32>(qkv, out, B, T, H, qkv_sb, qkv_st, out_sb, out_st, scale, s); break;
    case 64: launch<64>(qkv, out, B, T, H, qkv_sb, qkv_st, out_sb, out_st, scale, s); break;
    case 128: launch<128>(qkv, out, B, T, H, qkv_sb, qkv_st, out_sb, out_st, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
