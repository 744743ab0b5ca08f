// Shared device code of the attention kernels for Hopper (sm_90a): bf16
// helpers, the tensor memory accelerator (TMA) with mbarriers, and the
// products on the tensor cores.
//
// Tiles. Every tile the kernels stream is 64 rows of one head's d columns,
// copied by TMA from a 3-D tensor map over [B, T, width] (so rows at or past
// T, and only those, are zero-filled, and a tile never reads the next batch
// element) into shared memory in the layout wgmma reads: panels of
// PC = min(d, 64) columns, each 64 rows of PC * 2 bytes, swizzled by TMA's
// 64-byte (d = 32) or 128-byte (d >= 64) pattern, which XORs the 16-byte
// chunk index with the row bits of the address. Tile bases are 1024-byte
// aligned, so the pattern starts at row 0 of every tile.
//
// Products: wgmma, m64 x N x k16. A is always this warpgroup's 64 rows in
// registers (each warp owns 16 rows, in the m16n8k16 fragment layout); B is
// a shared tile read by descriptor, either with its rows as the output
// columns (K-major: s = q k^T) or with its rows as the contraction
// (MN-major: o = p v). Accumulators are flat fp32 arrays in wgmma's
// register order: element 4j + e is row g + 8 (e >> 1), column
// 8j + 2 t4 + (e & 1) of the warp's 16 rows (g = lane / 4, t4 = lane % 4).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cdae {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;          // rows per block (4 warps x 16) and per streamed tile
constexpr int NUM_THREADS = 128;  // one warpgroup
constexpr int STAGES = 3;         // shared-memory stages of the tile ring
constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x -> low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// bf16(x * scale) for a pair, the rounding of a bf16 x bf16 product.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float scale) {
  return pack_f32(bf16_lo(v) * scale, bf16_hi(v) * scale);
}

// A fragments of this warp's 16 rows straight from device memory, scaled
// when `scale` is not 1; rows at or past T are zero.
template <int KC>
__device__ __forceinline__ void a_frags_global(uint32_t (&f)[KC][4], const bf16* src,
                                               long long st, int row0, int T, float scale,
                                               int t4) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = kc * 16 + (r >> 1) * 8 + 2 * t4;
      uint32_t v = 0;
      if (row < T) {
        v = *reinterpret_cast<const uint32_t*>(src + row * st + col);
        if (scale != 1.f) v = scale_pair(v, scale);
      }
      f[kc][r] = v;
    }
}

// Accumulator pairs (j, j + 1) of 8 columns as the A fragment of a k16 step.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_f32(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_f32(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_f32(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------- tiles --

template <int D>
struct Tile {
  static constexpr int PC = D < 64 ? D : 64;   // columns per panel
  static constexpr int NP = D / PC;            // panels
  static constexpr int RB = PC * 2;            // bytes per panel row: 64 or 128
  static constexpr int PANEL = ROWS * RB;      // bytes per panel
  static constexpr int BYTES = ROWS * D * 2;   // bytes per tile
  static constexpr uint32_t MASK = RB / 16 - 1;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : 2;  // wgmma: 128B or 64B swizzle
  static constexpr CUtensorMapSwizzle SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;

  // Byte offset of element (row, col) from the tile's base.
  __device__ static __forceinline__ uint32_t offset(int row, int col) {
    const uint32_t lin = row * RB + (col % PC) * 2;
    return (col / PC) * PANEL + (lin ^ (((lin >> 7) & MASK) << 4));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, its base rounded up to 1024 bytes.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  const uint32_t base = smem_u32(raw);
  return raw + (((base + 1023u) & ~1023u) - base);
}

// x = bf16(x * scale) for every element of a tile, all threads; then made
// visible to the async proxy (wgmma reads the tile through it).
template <int D>
__device__ __forceinline__ void scale_tile(unsigned char* tile, float scale) {
  uint4* p = reinterpret_cast<uint4*>(tile) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < Tile<D>::BYTES / 16; i += NUM_THREADS) {
    uint4 v = p[i];
    v.x = scale_pair(v.x, scale);
    v.y = scale_pair(v.y, scale);
    v.z = scale_pair(v.z, scale);
    v.w = scale_pair(v.w, scale);
    p[i] = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------ mbarrier and TMA --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The ring's mbarriers, one per stage, each completed by one arrival (the
// copying thread's) and the bytes of its copies.
__device__ __forceinline__ void init_ring(uint64_t (&full)[STAGES]) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// One box of the 3-D tensor map at (column c0, row c1, batch c2).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A tile: rows row0.. of columns col0.. (one box per panel).
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int row0, int b) {
#pragma unroll
  for (int p = 0; p < Tile<D>::NP; ++p)
    tma_load(dst + p * Tile<D>::PANEL, map, bar, col0 + p * Tile<D>::PC, row0, b);
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------- products --

// wgmma, A (m64 x k16, bf16) from registers, B from a shared-memory
// descriptor, D (m64 x N, fp32) in registers; D = A B + (scale_d ? D : 0).
template <int TNSP_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}

template <int TNSP_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}

template <int TNSP_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// c (+)= A B with B[k][n] = tile[n][k]: a whole tile, its rows the output
// columns (K-major), K = D. Only started; mma_wait waits.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[ROWS / 2], const uint32_t (&a)[D / 16][4],
                                        const unsigned char* tile) {
  using L = Tile<D>;
  wgmma_fence();
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t addr = base + (kk * 16 / L::PC) * L::PANEL + (kk * 16 % L::PC) * 2;
    wgmma_rs<0>(c, a[kk], gmma_desc(addr, 16, 8 * L::RB, L::LAYOUT), kk > 0);
  }
}

// c += A B with B[k][n] = tile[k][n]: a tile of 64 rows, its rows the
// contraction (MN-major), N = D. Only started; mma_wait waits.
template <int D>
__device__ __forceinline__ void mma_ab(float (&c)[D / 2], const uint32_t (&a)[ROWS / 16][4],
                                       const unsigned char* tile) {
  using L = Tile<D>;
  wgmma_fence();
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    wgmma_rs<1>(c, a[kk], gmma_desc(base + kk * 16 * L::RB, L::PANEL, 8 * L::RB, L::LAYOUT), 1);
}

// Wait for the started wgmmas and pin their accumulators after the wait.
template <typename... Acc>
__device__ __forceinline__ void mma_wait(Acc&... acc) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  (reg_fence(acc), ...);
}

// ------------------------------------------------------------ host side --

// A 3-D tensor map over a bf16 [B, T, width] tensor with the given row and
// batch strides (elements), boxes of one panel by 64 rows; false if the
// encoder refuses. cuTensorMapEncodeTiled (libcuda, linked with -lcuda)
// needs a current context, and a thread that has made no runtime call has
// none (autograd runs the backward on a thread of its own): cudaSetDevice
// binds the primary context of the current device, which the caller sets
// to the tensor's. (cudaFree(0) would bind it too, but it is not allowed
// while a stream is being captured into a CUDA graph.)
template <int D>
inline bool make_tile_map(CUtensorMap* map, const void* base, int width, int T, int B,
                          long long st, long long sb) {
  int device;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {Tile<D>::PC, ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                Tile<D>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace cdae
