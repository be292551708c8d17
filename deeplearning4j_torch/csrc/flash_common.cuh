// Shared pieces of the flash-attention kernels: the forward K5
// (flash_attn_fwd.cu) and the backward K6 (flash_attn_dq.cu) and K7
// (flash_attn_dkv.cu). The products below are those of K5 and of the
// backward's f32 and non-wgmma bf16 bodies; the backward's wgmma route has
// its own in flash_hopper.cuh.
//
// Layout: q, k, v, o, do, dq, dk, dv are [bh, T, d] row-major in one type
// (bf16 or f32); lse, delta are [bh, T] f32; the key mask is [bh, Tk] f32
// (> 0 = a real key). Tq and Tk are multiples of 64.
//
// A block owns BM = 64 rows (16 per warp, four warps) and streams the
// other operand in tiles of BN = 64 rows through shared memory. Products
// are 16x8x16 warp tiles with f32 accumulators: `mma.sync` on the tensor
// cores for bf16 operands; for f32 operands the same tile is computed with
// f32 FMAs on the CUDA cores (tensor cores would round f32 to TF32). Both
// leave a thread the same four accumulator cells, so the softmax code
// above them is shared: cell e of a thread is (row g + 8*(e>>1),
// col 2*t + (e&1)) of the 16x8 tile, with g = lane/4 and t = lane%4.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j_flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;  // rows a block owns
constexpr int BN = 64;           // rows of a streamed tile
constexpr float kNeg = -1e30f;   // masked logit; lse of a row with no visible key
constexpr size_t kMaxSmem = 232448;

using bf16 = __nv_bfloat16;

// Row padding of shared-memory tiles, in elements: a bf16 row of DP + 8
// elements is DP/2 + 4 words, so the eight rows a fragment load touches
// fall on distinct banks.
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------- products
// A: a 16 x 16 tile, row-major with leading dimension lda. B: the 16 (k) x
// 8 (n) operand stored n-major, element (k, n) at b[n * ldb + k]; for
// C = X Y^T that is Y's rows as they are.
template <typename T> struct FragA;
template <typename T> struct FragB;
template <> struct FragA<bf16> { uint32_t r[4]; };
template <> struct FragB<bf16> { uint32_t r[2]; };
template <> struct FragA<float> { float v[2][16]; };   // rows g, g + 8
template <> struct FragB<float> { float v[2][16]; };   // cols 2t, 2t + 1

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void load_a(FragA<bf16>& f, const bf16* a, int lda, int lane) {
  const bf16* p = a + (lane >> 2) * lda + 2 * (lane & 3);
  f.r[0] = ld32(p);
  f.r[1] = ld32(p + 8 * lda);
  f.r[2] = ld32(p + 8);
  f.r[3] = ld32(p + 8 * lda + 8);
}

__device__ __forceinline__ void load_b(FragB<bf16>& f, const bf16* b, int ldb, int lane) {
  const bf16* p = b + (lane >> 2) * ldb + 2 * (lane & 3);
  f.r[0] = ld32(p);
  f.r[1] = ld32(p + 8);
}

__device__ __forceinline__ void mma(float c[4], const FragA<bf16>& a, const FragB<bf16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

__device__ __forceinline__ void load_a(FragA<float>& f, const float* a, int lda, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) f.v[i][k] = a[(g + 8 * i) * lda + k];
}

__device__ __forceinline__ void load_b(FragB<float>& f, const float* b, int ldb, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 16; ++k) f.v[j][k] = b[(2 * t + j) * ldb + k];
}

__device__ __forceinline__ void mma(float c[4], const FragA<float>& a, const FragB<float>& b) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 16; ++k) c[2 * i + j] = fmaf(a.v[i][k], b.v[j][k], c[2 * i + j]);
}

template <typename T, int NT>
__device__ __forceinline__ void tile_mma_step(float (&c)[NT][4], const T* a, int lda, const T* b,
                                              int ldb, int lane) {
  FragA<T> fa;
  load_a(fa, a, lda, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    FragB<T> fb;
    load_b(fb, b + n * 8 * ldb, ldb, lane);
    mma(c[n], fa, fb);
  }
}

// c[NT][4] += A (16 x K, at a) . B^T, B being NT*8 rows of K at b: the
// warp's 16 x (NT*8) tile. K is a multiple of 16. The f32 path keeps its
// k loop rolled: unrolled, its FMA tiles multiply the build time.
template <typename T, int NT, int K>
__device__ __forceinline__ void tile_mma(float (&c)[NT][4], const T* a, int lda, const T* b,
                                         int ldb, int lane) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) tile_mma_step(c, a + kk, lda, b + kk, ldb, lane);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < K; kk += 16) tile_mma_step(c, a + kk, lda, b + kk, ldb, lane);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// The warp's accumulator cells (rounded to T) into a 16-row shared tile.
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* s, int ls, const float (&c)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[(g + 8 * (e >> 1)) * ls + n * 8 + 2 * t + (e & 1)] = from_f<T>(c[n][e]);
}

// The warp's accumulator cells for its 16 rows of a [*, d] output, rounded
// to T, columns < d only; row r of the tile scaled by mul[r / 8].
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int d, const float (&c)[NT][4],
                                           const float mul[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      if (col < d) out[(size_t)(g + 8 * (e >> 1)) * d + col] = from_f<T>(c[n][e] * mul[e >> 1]);
    }
}

// Max and sum over the four threads of a quad (the threads that hold one row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ tiles
// R rows of a [*, d] row-major global matrix (starting at g) into shared
// memory, s[r * ls + c] or, kTrans, s[c * ls + r]; columns d..DP-1 are 0.
// With d == DP every row is a whole number of 16-byte chunks (DP is a
// multiple of 16), read as such.
template <typename T, int R, int DP, bool kTrans>
__device__ __forceinline__ void load_tile(T* s, int ls, const T* __restrict__ g, int d) {
  if (d == DP) {
    constexpr int E = 16 / sizeof(T);
    constexpr int C = DP / E;
    for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
      const int r = i / C, c = (i % C) * E;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(g + (size_t)r * d + c));
      if constexpr (kTrans) {
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < E; ++j) s[(c + j) * ls + r] = e[j];
      } else {
        *reinterpret_cast<uint4*>(s + r * ls + c) = u;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      const T x = c < d ? g[(size_t)r * d + c] : from_f<T>(0.f);
      if constexpr (kTrans) s[c * ls + r] = x;
      else s[r * ls + c] = x;
    }
  }
}

// ---------------------------------------------------------------- dropout
// The counter hash of deeplearning4j_tpu/ops/flash_attention.py
// `_keep_from_coords`, bit for bit: murmur3 fmix32 in uint32 arithmetic
// (logical shifts, wrapping products) over the global coordinates.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// fmix32(seed ^ bh * phi): the per-(batch x head) part of the hash.
__device__ __forceinline__ uint32_t hash_bh(int seed, int bh) {
  return fmix32((uint32_t)seed ^ ((uint32_t)bh * 0x9E3779B9u));
}

__device__ __forceinline__ bool keep_cell(uint32_t hbh, uint32_t qpos, uint32_t kpos, float rate) {
  uint32_t x = fmix32(hbh ^ (qpos * 0x01000193u + kpos));
  x = fmix32(x ^ (kpos * 0x9E3779B9u));
  return (float)(x & 0x7FFFFFu) * (1.0f / 8388608.0f) >= rate;
}

// Everything a kernel needs besides its tensors.
struct Params {
  int bh, Tq, Tk, d;
  float scale;
  int causal;
  float rate, inv_keep;  // dropout rate and 1 / (1 - rate)
  int seed, q_off, k_off;
};

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

inline bool shape_ok(const Params& p) {
  static_assert(BM == 64 && BN == 64, "tiles of both kinds cover 64 rows");
  return p.bh > 0 && p.bh <= 65535 && p.Tq > 0 && p.Tk > 0 && p.Tq % 64 == 0 && p.Tk % 64 == 0
         && p.d > 0 && p.d <= 256;
}

}  // namespace dl4j_flash

// `return LAUNCH<T, DP>(args...)` for the padded head dim DP (16, 32, 64,
// 128 or 256) of p.d; f32 operands take d <= 128 (shared memory).
#define DL4J_FLASH_BY_DP(T, LAUNCH, ...)                         \
  do {                                                           \
    if (p.d <= 16) return LAUNCH<T, 16>(__VA_ARGS__);            \
    if (p.d <= 32) return LAUNCH<T, 32>(__VA_ARGS__);            \
    if (p.d <= 64) return LAUNCH<T, 64>(__VA_ARGS__);            \
    if (p.d <= 128) return LAUNCH<T, 128>(__VA_ARGS__);          \
    if constexpr (sizeof(T) == 2) {                              \
      if (p.d <= 256) return LAUNCH<T, 256>(__VA_ARGS__);        \
    }                                                            \
    return (int)cudaErrorInvalidValue;                           \
  } while (0)

extern "C" const char* dl4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
