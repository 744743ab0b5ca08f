// GroupNorm + optional scale-shift + optional SiLU for Hopper (sm_90a), one
// pass each way, bf16 or fp32 in and out.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it (causaldiffae_tpu/models/layers.py:138-154; its Pallas GroupNorm
// kernel was removed, layers.py:114-124). Eager PyTorch does not fuse it: the
// port's GroupNorm32 chain took 15-18 launches forward and 25-30 backward per
// call, most over the whole activation in fp32. Per batch element b and
// group g of x [B, C, S] (S the spatial size), with N = C/G * S:
//   mean = sum(x) / N, msq = sum(x * x) / N in fp32,
//   rstd = rsqrt(msq - mean^2 + eps)                  (layers.py:62-68)
//   y    = T(((x - mean) * rstd) * w[c] + bias[c])    affine in fp32
//   y    = T(T(y * T(1 + scale[b, c])) + shift[b, c])  where scale-shift is asked
//   y    = T(y * T(sigmoid(y)))                        where SiLU is asked
// with T() the rounding to the input type T at the points where the eager
// chain rounds, each operation rounded to fp32 as its own eager kernel does
// (no fused multiply-add), so the output equals the eager chain's bit for
// bit except where the statistics' summation order flips a rounding. It
// saves mean and rstd (fp32 [B, G]) for the backward when asked.
//
// The backward recomputes x-hat and the pre-activation values from x and the
// saved statistics, takes dy through the SiLU (fp32 sigmoid of the rounded
// value) and the scale-shift, then through the GroupNorm, in fp32:
//   g1 = dy * silu'(z) * (1 + scale)      z the rounded pre-activation
//   d_shift[b, c] = sum dy * silu'(z), d_scale[b, c] = sum dy * silu'(z) * y
//   d_bias[c] = sum_b sum g1, d_weight[c] = sum_b sum g1 * x-hat
//   dx = rstd * (g1 w - mean_group(g1 w) - x-hat * mean_group(g1 w x-hat))
// Every sum has a fixed order (no float atomics): two runs give equal bits.
//
// What bounds it on an H100: bytes. Forward reads x once and writes y once
// (4 B an element in bf16), backward reads x and dy and writes dx (6 B), at
// 3.35 TB/s; a few tens of fp32 operations an element stay below that. The
// design keeps each element in registers between its two passes:
// - A group is cut into 16-byte chunks (8 bf16 or 4 fp32 values of one
//   channel, where S is a multiple of that; else single elements). A block of
//   TPB threads holds up to MAXCH chunks a thread in registers, so it holds
//   up to 32 KB of a group. A larger group is split over a thread-block
//   cluster of up to 8 blocks, which exchange their partial sums through
//   distributed shared memory; past 8 blocks the chunks beyond the registers
//   are read again in the second pass. The split (cluster size, threads,
//   chunks a thread) follows from the group's size and the dtype alone
//   (`plan`): 73,728 bf16 elements (256 channels at 96x96) take 8 blocks of
//   288 threads, 2,304 (512 at 12x12) one block of 96.
// - Chunk k of a group sits in row k / TPB; rows go round-robin to the
//   cluster's blocks, so each block reads whole 16-byte-per-thread rows.
// - Backward: per-(b, c) sums are taken row by row, each channel's part of a
//   row summed by one warp from the threads' chunk sums in shared memory, then
//   over the cluster in rank order; per-channel sums over b in a second,
//   small launch.
//
// Plain C interface (built with nvcc, loaded with ctypes):
//   int cdae_norm_act_fwd(const void* x, void* y, const float* w,
//                         const float* bias, const void* scale,
//                         const void* shift, long long ss_stride, float* mean,
//                         float* rstd, int B, int C, long long S, int G,
//                         int bf16, int silu, float eps, void* stream)
//   int cdae_norm_act_bwd(const void* x, const void* dy, const float* w,
//                         const float* bias, const void* scale,
//                         const void* shift, long long ss_stride,
//                         const float* mean, const float* rstd, void* dx,
//                         void* dscale, void* dshift, float* part, float* dwb,
//                         int B, int C, long long S, int G, int bf16, int silu,
//                         void* stream)
//   int cdae_norm_act_plan(int C, long long S, int G, int bf16, int aligned,
//                          int* out)   // out: vec, cluster, threads, slots
// x, y, dy and dx are contiguous [B, C, S] of T (bf16 where `bf16`, else
// fp32); w and bias fp32 [C]; scale and shift null or T rows of C values,
// `ss_stride` elements apart; mean and rstd null (forward) or fp32 [B, G];
// dscale and dshift T [B, C] (written where scale is given); part fp32
// scratch [2, B, C]; dwb fp32 [2, C] (d_weight, then d_bias). Each function
// launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success; -1 for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cdae {
namespace {

constexpr int MAXCH = 4;          // chunks a thread holds in registers
constexpr int MAX_TPB = 512;
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int NQ = 4;             // backward per-channel sums: shift, scale, bias, weight
constexpr int MAX_SMEM = 200 * 1024;   // a backward block's dynamic shared memory

// ---- element access ------------------------------------------------------
// Values travel as fp32. A bf16 value widens by a shift; rounding to bf16 is a
// conversion on the unit that also computes exp and rcp (16 a clock per SM,
// an eighth of the fp32 rate), so values are rounded two at a time, and a
// value already rounded is stored by taking its upper half.

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// both values rounded to T, round to nearest even
template <typename T> __device__ __forceinline__ void rnd2(float (&v)[2]);
template <> __device__ __forceinline__ void rnd2<float>(float (&)[2]) {}
template <> __device__ __forceinline__ void rnd2<__nv_bfloat16>(float (&v)[2]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

template <typename T> __device__ __forceinline__ float ld_elem(const T* p);
template <> __device__ __forceinline__ float ld_elem<float>(const float* p) { return __ldg(p); }
template <> __device__ __forceinline__ float ld_elem<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __uint_as_float(uint32_t(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// store v, already rounded to T
template <typename T> __device__ __forceinline__ void st_elem(T* p, float v);
template <> __device__ __forceinline__ void st_elem<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void st_elem<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

// A chunk: 16 bytes (VEC) or one element, as raw bits in registers. `set`
// takes a value already rounded to T.
template <typename T, bool VEC> struct Io;

template <typename T> struct Io<T, true> {
  static constexpr int V = 16 / sizeof(T);
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void store(T* p, const Raw& r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
    if (sizeof(T) == 4) return __uint_as_float(w[i]);
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
  static __device__ __forceinline__ void set(Raw& r, int i, float v) {
    uint32_t* w = reinterpret_cast<uint32_t*>(&r);
    if (sizeof(T) == 4) {
      w[i] = __float_as_uint(v);
    } else if (i & 1) {
      w[i >> 1] = (w[i >> 1] & 0xffffu) | (__float_as_uint(v) & 0xffff0000u);
    } else {
      w[i >> 1] = (w[i >> 1] & 0xffff0000u) | (__float_as_uint(v) >> 16);
    }
  }
};

template <typename T> struct Io<T, false> {
  static constexpr int V = 1;
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return ld_elem<T>(p); }
  static __device__ __forceinline__ void store(T* p, const Raw& r) { st_elem<T>(p, r); }
  static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
  static __device__ __forceinline__ void set(Raw& r, int, float v) { r = v; }
};

// ---- clusters ------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// a float in block `rank`'s shared memory at the address of `p` in this one's
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t ra;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(ra) : "memory");
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;   // the same bits in every lane (each step adds the same pair)
}

// ---- arguments -----------------------------------------------------------

struct Args {
  const void* x;
  const void* dy;
  void* out;             // y (forward) or dx (backward)
  const float* w;
  const float* bias;
  const void* scale;
  const void* shift;
  long long ss_stride;
  float* mean;
  float* rstd;
  void* dscale;
  void* dshift;
  float* part;
  int B, C, G, cpg;
  int S;                 // spatial size
  int N;                 // elements of a group
  int NC;                // chunks of a group
  int CL, slots;
  int silu;
  float eps;
};

// A channel's affine and scale-shift: w, bias, T(1 + scale), shift.
struct Chan {
  float w, b, sp, sh;
};

template <typename T>
__device__ __forceinline__ Chan chan(const Args& a, int b, int c) {
  Chan p;
  p.w = __ldg(a.w + c);
  p.b = __ldg(a.bias + c);
  if (a.scale != nullptr) {
    const long long o = (long long)b * a.ss_stride + c;
    p.sp = rnd<T>(__fadd_rn(1.0f, ld_elem<T>(static_cast<const T*>(a.scale) + o)));
    p.sh = ld_elem<T>(static_cast<const T*>(a.shift) + o);
  } else {
    p.sp = 1.0f;
    p.sh = 0.0f;
  }
  return p;
}

// Two elements of a channel: x-hat, the rounded affine output y1 and
// pre-activation z, and where SiLU is asked the fp32 sigmoid s of z: with
// EXACT as the eager kernel computes it, 1 / (1 + exp(-z)) with IEEE exp and
// division (its rounding decides the output's), else with the fast exp (the
// backward's derivative, a few fp32 ulps off). Each operation rounded to fp32
// alone, as its eager kernel rounds it.
template <typename T, bool EXACT>
__device__ __forceinline__ void pre2(const float (&x)[2], float mean, float rstd, const Chan& p,
                                     bool ss, bool silu, float (&xh)[2], float (&y1)[2],
                                     float (&z)[2], float (&s)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    xh[i] = __fmul_rn(__fsub_rn(x[i], mean), rstd);
    y1[i] = __fadd_rn(__fmul_rn(xh[i], p.w), p.b);
  }
  rnd2<T>(y1);
  if (ss) {
    float m[2] = {__fmul_rn(y1[0], p.sp), __fmul_rn(y1[1], p.sp)};
    rnd2<T>(m);
    z[0] = __fadd_rn(m[0], p.sh);
    z[1] = __fadd_rn(m[1], p.sh);
    rnd2<T>(z);
  } else {
    z[0] = y1[0];
    z[1] = y1[1];
  }
  if (silu) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      s[i] = EXACT ? __frcp_rn(__fadd_rn(1.0f, expf(-z[i]))) : __frcp_rn(1.0f + __expf(-z[i]));
  }
}

// The group's channels' affine and scale-shift into cp[cpg] (shared memory).
template <typename T>
__device__ __forceinline__ void load_chans(const Args& a, int b, int g, Chan* cp) {
  for (int t = threadIdx.x; t < a.cpg; t += blockDim.x) cp[t] = chan<T>(a, b, g * a.cpg + t);
}

// The group's channel of chunk k, k / cpv, by a float reciprocal and a fix-up
// (the estimate of a channel below 2^20 is off by at most one).
__device__ __forceinline__ int chan_of(int k, int cpv, float inv_cpv) {
  int c = static_cast<int>(static_cast<float>(k) * inv_cpv);
  if ((c + 1) * cpv <= k) ++c;
  else if (c * cpv > k) --c;
  return c;
}

// One chunk's index in the group: row j * CL + rank of TPB chunks, lane tid.
__device__ __forceinline__ int chunk_of(const Args& a, int j, unsigned rank) {
  return (j * a.CL + static_cast<int>(rank)) * static_cast<int>(blockDim.x) + threadIdx.x;
}

// The elements of a chunk two at a time (a single element twice where V is 1).
#define CDAE_PAIRS(i, i1, V) \
  for (int i = 0, i1 = (V) > 1 ? 1 : 0; i < (V); i += 2, i1 = i + ((V) > 1 ? 1 : 0))

// One chunk of the forward's output from its input chunk, channel c.
template <typename T, bool VEC>
__device__ __forceinline__ void emit_fwd(T* y, int k, const typename Io<T, VEC>::Raw& in,
                                         const Chan& p, float mean, float rstd, bool ss,
                                         bool silu) {
  using IO = Io<T, VEC>;
  typename IO::Raw o;
#pragma unroll
  CDAE_PAIRS(i, i1, IO::V) {
    const float x[2] = {IO::get(in, i), IO::get(in, i1)};
    float xh[2], y1[2], z[2], s[2];
    pre2<T, true>(x, mean, rstd, p, ss, silu, xh, y1, z, s);
    if (silu) {
      rnd2<T>(s);
      z[0] = __fmul_rn(z[0], s[0]);
      z[1] = __fmul_rn(z[1], s[1]);
      rnd2<T>(z);
    }
    IO::set(o, i, z[0]);
    IO::set(o, i1, z[1]);
  }
  IO::store(y + (long long)k * IO::V, o);
}

// g1 of one chunk (channel c) into gv[i * gs], and its sums (shift, scale,
// bias, weight) added to q.
template <typename T, bool VEC>
__device__ __forceinline__ void chunk_grads(const typename Io<T, VEC>::Raw& xr,
                                            const typename Io<T, VEC>::Raw& dr, const Chan& p,
                                            float mean, float rstd, bool ss, bool silu,
                                            float* gv, int gs, float (&q)[NQ]) {
  using IO = Io<T, VEC>;
#pragma unroll
  CDAE_PAIRS(i, i1, IO::V) {
    const float x[2] = {IO::get(xr, i), IO::get(xr, i1)};
    const float d[2] = {IO::get(dr, i), IO::get(dr, i1)};
    float xh[2], y1[2], z[2], s[2];
    pre2<T, false>(x, mean, rstd, p, ss, silu, xh, y1, z, s);
#pragma unroll
    for (int e = 0; e < (IO::V > 1 ? 2 : 1); ++e) {
      const float gz = silu ? d[e] * (s[e] * (1.0f + z[e] * (1.0f - s[e]))) : d[e];
      const float g1 = ss ? gz * p.sp : gz;   // through the scale
      q[0] += gz;
      q[1] += gz * y1[e];
      q[2] += g1;
      q[3] += g1 * xh[e];
      gv[(e ? i1 : i) * gs] = g1;
    }
  }
}

// One chunk of dx (channel c) from x and g1 (gin[i * gs]).
template <typename T, bool VEC>
__device__ __forceinline__ void emit_bwd(T* dx, int k, const typename Io<T, VEC>::Raw& xin,
                                         const float* gin, int gs, float w, float mean,
                                         float rstd, float m1, float m2) {
  using IO = Io<T, VEC>;
  typename IO::Raw o;
#pragma unroll
  CDAE_PAIRS(i, i1, IO::V) {
    float v[2];
    const int ix[2] = {i, i1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xh = __fmul_rn(__fsub_rn(IO::get(xin, ix[e]), mean), rstd);
      v[e] = rstd * (gin[ix[e] * gs] * w - m1 - xh * m2);
    }
    rnd2<T>(v);
    IO::set(o, i, v[0]);
    IO::set(o, i1, v[1]);
  }
  IO::store(dx + (long long)k * IO::V, o);
}

// The threads' chunk sums of rows [0, nrows) (rows[j][NQ][TPB]) added to
// acc[NQ][cpg], rows j0 + j of the group: each channel of a row summed by one
// warp, the rows of a channel in order.
__device__ __forceinline__ void fold_rows(const Args& a, const float* rows, float* acc, int j0,
                                          int nrows, unsigned rank, int cpv) {
  const int tpb = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  for (int c = warp; c < a.cpg; c += tpb >> 5) {
    float q[NQ] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < nrows; ++j) {
      const int k0 = ((j0 + j) * a.CL + static_cast<int>(rank)) * tpb;
      const int lo = max(k0, c * cpv), hi = min(min(k0 + tpb, a.NC), (c + 1) * cpv);
      for (int t = lo - k0 + lane; t < hi - k0; t += 32) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) q[n] += rows[(j * NQ + n) * tpb + t];
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n) q[n] = warp_sum(q[n]);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) acc[n * a.cpg + c] += q[n];   // one warp per channel
    }
  }
  __syncthreads();
}

// ---- forward -------------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(MAX_TPB) norm_act_fwd_kernel(const Args a) {
  using IO = Io<T, VEC>;
  constexpr int V = IO::V;
  extern __shared__ float smem[];
  __shared__ float red[2][MAX_TPB / 32];
  __shared__ float part[2], total[2];
  Chan* cp = reinterpret_cast<Chan*>(smem);   // [cpg]
  const unsigned rank = a.CL > 1 ? cluster_rank() : 0u;
  const int bg = blockIdx.x / a.CL, b = bg / a.G, g = bg % a.G;
  const T* x = static_cast<const T*>(a.x) + (long long)bg * a.N;
  T* y = static_cast<T*>(a.out) + (long long)bg * a.N;
  const bool ss = a.scale != nullptr, silu = a.silu != 0;

  typename IO::Raw reg[MAXCH];
  float s = 0.0f, sq = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    const int k = chunk_of(a, j, rank);
    if (j < a.slots && k < a.NC) reg[j] = IO::load(x + (long long)k * V);
  }
  load_chans<T>(a, b, g, cp);   // read after the __syncthreads below
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    const int k = chunk_of(a, j, rank);
    if (j < a.slots && k < a.NC) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = IO::get(reg[j], i);
        s += v;
        sq = fmaf(v, v, sq);
      }
    }
  }
  for (int j = MAXCH; j < a.slots; ++j) {   // past the registers: read again below
    const int k = chunk_of(a, j, rank);
    if (k < a.NC) {
      const typename IO::Raw r = IO::load(x + (long long)k * V);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = IO::get(r, i);
        s += v;
        sq = fmaf(v, v, sq);
      }
    }
  }

  // block, then cluster: fixed orders, the same sums in every thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  s = warp_sum(s);
  sq = warp_sum(sq);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f, tq = 0.0f;
    for (int w = 0; w < nw; ++w) {
      ts += red[0][w];
      tq += red[1][w];
    }
    part[0] = total[0] = ts;
    part[1] = total[1] = tq;
  }
  if (a.CL > 1) {
    cluster_arrive();
    cluster_wait();   // every block's part is written
    if (threadIdx.x == 0) {
      float ts = 0.0f, tq = 0.0f;
      for (int r = 0; r < a.CL; ++r) {
        ts += ld_cluster(&part[0], r);
        tq += ld_cluster(&part[1], r);
      }
      total[0] = ts;
      total[1] = tq;
    }
    cluster_arrive();   // done reading the others' parts; waited for before exit
  }
  __syncthreads();
  const float inv_n = 1.0f / static_cast<float>(a.N);
  const float mean = __fmul_rn(total[0], inv_n);
  const float msq = __fmul_rn(total[1], inv_n);
  const float rstd = rsqrtf(__fadd_rn(__fsub_rn(msq, __fmul_rn(mean, mean)), a.eps));
  if (a.mean != nullptr && rank == 0 && threadIdx.x == 0) {
    a.mean[bg] = mean;
    a.rstd[bg] = rstd;
  }

  const int cpv = a.S / V;   // chunks of a channel
  const float inv_cpv = 1.0f / static_cast<float>(cpv);
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    const int k = chunk_of(a, j, rank);
    if (j < a.slots && k < a.NC)
      emit_fwd<T, VEC>(y, k, reg[j], cp[chan_of(k, cpv, inv_cpv)], mean, rstd, ss, silu);
  }
  for (int j = MAXCH; j < a.slots; ++j) {
    const int k = chunk_of(a, j, rank);
    if (k < a.NC)
      emit_fwd<T, VEC>(y, k, IO::load(x + (long long)k * V), cp[chan_of(k, cpv, inv_cpv)], mean,
                       rstd, ss, silu);
  }
  if (a.CL > 1) cluster_wait();   // no block leaves while another reads its part
}

// ---- backward ------------------------------------------------------------

// Shared memory: cp [cpg] (the channels' affine and scale-shift), rows
// [MAXCH][NQ][TPB] (each thread's chunk sums by row),
// gsm [MAXCH][V][TPB] (g1 of the chunks held, kept for the second pass out of
// the registers, so that more blocks share an SM), acc [NQ][cpg] (this
// block's per-channel sums), tot [NQ][cpg] (the cluster's). Every load of x
// and dy is issued before the first sum.
template <typename T, bool VEC>
__global__ void __launch_bounds__(MAX_TPB) norm_act_bwd_kernel(const Args a) {
  using IO = Io<T, VEC>;
  constexpr int V = IO::V;
  extern __shared__ float smem[];
  __shared__ float red[2];
  const int tpb = blockDim.x, cpg = a.cpg;
  Chan* cp = reinterpret_cast<Chan*>(smem);
  float* rows = smem + 4 * cpg;
  float* gsm = rows + MAXCH * NQ * tpb;
  float* acc = gsm + MAXCH * V * tpb;
  float* tot = acc + NQ * cpg;
  const unsigned rank = a.CL > 1 ? cluster_rank() : 0u;
  const int bg = blockIdx.x / a.CL, b = bg / a.G, g = bg % a.G;
  const long long base = (long long)bg * a.N;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* dy = static_cast<const T*>(a.dy) + base;
  const bool ss = a.scale != nullptr, silu = a.silu != 0;
  const float mean = __ldg(a.mean + bg), rstd = __ldg(a.rstd + bg);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpv = a.S / V;
  const float inv_cpv = 1.0f / static_cast<float>(cpv);
  const int held = min(a.slots, MAXCH);

  for (int i = threadIdx.x; i < NQ * cpg; i += tpb) acc[i] = 0.0f;
  load_chans<T>(a, b, g, cp);

  typename IO::Raw xr[MAXCH], dr[MAXCH];
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    const int k = chunk_of(a, j, rank);
    if (j < a.slots && k < a.NC) {
      xr[j] = IO::load(x + (long long)k * V);
      dr[j] = IO::load(dy + (long long)k * V);
    }
  }
  __syncthreads();   // cp
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    if (j < a.slots) {
      const int k = chunk_of(a, j, rank);
      float q[NQ] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (k < a.NC)
        chunk_grads<T, VEC>(xr[j], dr[j], cp[chan_of(k, cpv, inv_cpv)], mean, rstd, ss, silu,
                            gsm + j * V * tpb + threadIdx.x, tpb, q);
#pragma unroll
      for (int n = 0; n < NQ; ++n) rows[(j * NQ + n) * tpb + threadIdx.x] = q[n];
    }
  }
  fold_rows(a, rows, acc, 0, held, rank, cpv);
  for (int j = MAXCH; j < a.slots; ++j) {   // past the registers, row by row
    const int k = chunk_of(a, j, rank);
    float q[NQ] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < a.NC) {
      float gs[V];
      chunk_grads<T, VEC>(IO::load(x + (long long)k * V), IO::load(dy + (long long)k * V),
                          cp[chan_of(k, cpv, inv_cpv)], mean, rstd, ss, silu, gs, 1, q);
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n) rows[n * tpb + threadIdx.x] = q[n];
    fold_rows(a, rows, acc, j, 1, rank, cpv);
  }

  // the cluster's per-channel sums, in rank order, the same in every block
  if (a.CL > 1) {
    cluster_arrive();
    cluster_wait();
    for (int i = threadIdx.x; i < NQ * cpg; i += tpb) {
      float t = 0.0f;
      for (int r = 0; r < a.CL; ++r) t += ld_cluster(&acc[i], r);
      tot[i] = t;
    }
    cluster_arrive();
  } else {
    for (int i = threadIdx.x; i < NQ * cpg; i += tpb) tot[i] = acc[i];
  }
  __syncthreads();
  // the group's mean of g1 w and of g1 w x-hat
  if (warp == 0) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < cpg; c += 32) {
      s1 += cp[c].w * tot[2 * cpg + c];
      s2 += cp[c].w * tot[3 * cpg + c];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0] = s1 / static_cast<float>(a.N);
      red[1] = s2 / static_cast<float>(a.N);
    }
  }
  if (rank == 0) {   // per (b, c): d_shift, d_scale in T; d_bias, d_weight partials in fp32
    for (int c = threadIdx.x; c < cpg; c += tpb) {
      const long long o = (long long)b * a.C + g * cpg + c;
      if (ss) {
        st_elem<T>(static_cast<T*>(a.dshift) + o, rnd<T>(tot[c]));
        st_elem<T>(static_cast<T*>(a.dscale) + o, rnd<T>(tot[cpg + c]));
      }
      a.part[(long long)a.B * a.C + o] = tot[2 * cpg + c];   // d_bias
      a.part[o] = tot[3 * cpg + c];                         // d_weight
    }
  }
  __syncthreads();
  const float m1 = red[0], m2 = red[1];

  T* dx = static_cast<T*>(a.out) + base;
#pragma unroll
  for (int j = 0; j < MAXCH; ++j) {
    const int k = chunk_of(a, j, rank);
    if (j < a.slots && k < a.NC)
      emit_bwd<T, VEC>(dx, k, xr[j], gsm + j * V * tpb + threadIdx.x, tpb,
                       cp[chan_of(k, cpv, inv_cpv)].w, mean, rstd, m1, m2);
  }
  for (int j = MAXCH; j < a.slots; ++j) {
    const int k = chunk_of(a, j, rank);
    if (k < a.NC) {
      const typename IO::Raw xin = IO::load(x + (long long)k * V);
      float gs[V], q[NQ] = {0.0f, 0.0f, 0.0f, 0.0f};
      const Chan& p = cp[chan_of(k, cpv, inv_cpv)];
      chunk_grads<T, VEC>(xin, IO::load(dy + (long long)k * V), p, mean, rstd, ss, silu, gs, 1,
                          q);
      emit_bwd<T, VEC>(dx, k, xin, gs, 1, p.w, mean, rstd, m1, m2);
    }
  }
  if (a.CL > 1) cluster_wait();
}

// d_weight and d_bias: the per-(b, c) partials summed over b in order.
__global__ void norm_act_wb_kernel(const float* part, float* dwb, int B, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * C) return;
  const int q = i / C, c = i - q * C;
  const float* p = part + (long long)q * B * C + c;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += p[(long long)b * C];
  dwb[i] = s;
}

// ---- plan and launch -----------------------------------------------------

struct Plan {
  bool vec;
  int V, NC, CL, TPB, slots;
};

// The split of one group of `n` elements of `esize` bytes, S of a channel:
// 16-byte chunks where S holds whole chunks and the tensors are aligned; the
// smallest cluster whose blocks hold the group in registers (at most 8); the
// fewest warps that hold a block's share at MAXCH chunks a thread.
Plan plan(long long n, int S, int esize, bool aligned) {
  Plan p;
  p.V = 16 / esize;
  p.vec = aligned && S % p.V == 0;
  if (!p.vec) p.V = 1;
  p.NC = static_cast<int>(n / p.V);
  p.CL = 1;
  while (p.CL < MAX_CLUSTER && p.NC > p.CL * MAX_TPB * MAXCH) p.CL *= 2;
  const int per = (p.NC + p.CL - 1) / p.CL;
  int tpb = ((per + MAXCH - 1) / MAXCH + 31) / 32 * 32;
  p.TPB = tpb < 32 ? 32 : (tpb > MAX_TPB ? MAX_TPB : tpb);
  const int rows = (p.NC + p.TPB - 1) / p.TPB;
  p.slots = (rows + p.CL - 1) / p.CL;
  return p;
}

template <typename K>
cudaError_t launch(K kernel, const Plan& p, int groups, size_t smem, cudaStream_t stream,
                   const Args& a) {
  const dim3 grid(p.CL * groups), block(p.TPB);
  if (smem > 48 * 1024) {   // above 48 KB a kernel takes dynamic shared memory on request
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (p.CL == 1) {
    kernel<<<grid, block, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Shape checks and the fields every launch shares; false for what the kernels do not take.
bool setup(Args& a, Plan& p, int B, int C, long long S, int G, int bf16, bool aligned) {
  if (B < 1 || C < 1 || S < 1 || G < 1 || C % G != 0) return false;
  const long long n = static_cast<long long>(C / G) * S;
  if (n >= (1ll << 30) || S >= (1ll << 30) || static_cast<long long>(B) * G * MAX_CLUSTER >= (1ll << 31))
    return false;
  p = plan(n, static_cast<int>(S), bf16 ? 2 : 4, aligned);
  a.B = B;
  a.C = C;
  a.G = G;
  a.cpg = C / G;
  a.S = static_cast<int>(S);
  a.N = static_cast<int>(n);
  a.NC = p.NC;
  a.CL = p.CL;
  a.slots = p.slots;
  return true;
}

}  // namespace
}  // namespace cdae

using namespace cdae;

extern "C" int cdae_norm_act_plan(int C, long long S, int G, int bf16, int aligned, int* out) {
  if (C < 1 || G < 1 || C % G != 0 || S < 1) return -1;
  const Plan p = plan(static_cast<long long>(C / G) * S, static_cast<int>(S), bf16 ? 2 : 4,
                      aligned != 0);
  out[0] = p.vec;
  out[1] = p.CL;
  out[2] = p.TPB;
  out[3] = p.slots;
  return 0;
}

extern "C" int cdae_norm_act_fwd(const void* x, void* y, const float* w, const float* bias,
                                 const void* scale, const void* shift, long long ss_stride,
                                 float* mean, float* rstd, int B, int C, long long S, int G,
                                 int bf16, int silu, float eps, void* stream) {
  Args a = {};
  Plan p;
  if (!setup(a, p, B, C, S, G, bf16, aligned16(x) && aligned16(y))) return -1;
  a.x = x;
  a.out = y;
  a.w = w;
  a.bias = bias;
  a.scale = scale;
  a.shift = shift;
  a.ss_stride = ss_stride;
  a.mean = mean;
  a.rstd = rstd;
  a.silu = silu;
  a.eps = eps;
  const size_t smem = sizeof(Chan) * a.cpg;
  if (smem > MAX_SMEM) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = p.vec ? launch(norm_act_fwd_kernel<__nv_bfloat16, true>, p, B * G, smem, st, a)
                : launch(norm_act_fwd_kernel<__nv_bfloat16, false>, p, B * G, smem, st, a);
  } else {
    err = p.vec ? launch(norm_act_fwd_kernel<float, true>, p, B * G, smem, st, a)
                : launch(norm_act_fwd_kernel<float, false>, p, B * G, smem, st, a);
  }
  return static_cast<int>(err);
}

extern "C" int cdae_norm_act_bwd(const void* x, const void* dy, const float* w,
                                 const float* bias, const void* scale, const void* shift,
                                 long long ss_stride, const float* mean, const float* rstd,
                                 void* dx, void* dscale, void* dshift, float* part, float* dwb,
                                 int B, int C, long long S, int G, int bf16, int silu,
                                 void* stream) {
  Args a = {};
  Plan p;
  if (!setup(a, p, B, C, S, G, bf16, aligned16(x) && aligned16(dy) && aligned16(dx)))
    return -1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(MAXCH) * (NQ + p.V) * p.TPB +
                                       2 * NQ * a.cpg) + sizeof(Chan) * a.cpg;
  if (smem > MAX_SMEM) return -1;
  a.x = x;
  a.dy = dy;
  a.out = dx;
  a.w = w;
  a.bias = bias;
  a.scale = scale;
  a.shift = shift;
  a.ss_stride = ss_stride;
  a.mean = const_cast<float*>(mean);
  a.rstd = const_cast<float*>(rstd);
  a.dscale = dscale;
  a.dshift = dshift;
  a.part = part;
  a.silu = silu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = p.vec ? launch(norm_act_bwd_kernel<__nv_bfloat16, true>, p, B * G, smem, st, a)
                : launch(norm_act_bwd_kernel<__nv_bfloat16, false>, p, B * G, smem, st, a);
  } else {
    err = p.vec ? launch(norm_act_bwd_kernel<float, true>, p, B * G, smem, st, a)
                : launch(norm_act_bwd_kernel<float, false>, p, B * G, smem, st, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_act_wb_kernel<<<(2 * C + 255) / 256, 256, 0, st>>>(part, dwb, B, C);
  return static_cast<int>(cudaGetLastError());
}
