// Hopper pieces of the flash-attention kernels K5 (flash_attn_fwd.cu), K6
// (flash_attn_dq.cu) and K7 (flash_attn_dkv.cu) on their wgmma route: TMA
// tile loads into an mbarrier-guarded ring, `wgmma` products, and the
// warp-specialised block they share.
//
// Block: three warpgroups. Warpgroups 0 and 1 are consumers, each owning 64
// rows (queries in K5 and K6, keys in K7); warpgroup 2 is the producer, one thread
// of which issues every TMA copy. `setmaxnreg` moves registers from the
// producer (24 a thread) to the consumers (240). ptxas (CUDA 12.9) reports
// 168 registers a thread for these kernels and spills the same with or
// without it: the consumers' code is allocated within the launch's 168.
//
// Shared-memory tiles are 64 rows of DP bf16 values, stored as DP/64 chunks
// of [64 rows][64 columns] (8 KB each), each chunk as TMA writes it with the
// 128-byte swizzle: the 16-byte unit u of row r sits at unit u ^ (r % 8).
// Every chunk starts on a 1024-byte boundary, so that the `wgmma`
// descriptors (layout SWIZZLE_128B) see the same pattern.
//
// A tile is read by `wgmma` two ways:
// - K-major (d contiguous, the product's K dimension): the operand of
//   s = q . k^T and dp = do . v^T, for either side. A k16 step advances the
//   start address by 32 bytes inside the 128-byte row, crossing to the next
//   chunk every four steps; rows step by 128 bytes, 8-row groups by 1024
//   (SBO).
// - MN-major (rows are the product's K dimension, d its N): the B operand
//   of dq += ds . k (K6) and dv += pd^T . do, dk += ds^T . q (K7). A k16
//   step is 16 rows, 2048 bytes; SBO 1024 steps over 8 rows; a 64-column
//   chunk is one n64 product.
//
// The accumulator of an m64nNk16 product: warp w of the warpgroup holds rows
// 16w..16w+15; cell i of a thread (lane = 4g + t) is row 16w + g + 8*((i>>1)&1),
// column 8*(i>>2) + 2t + (i&1). Cells 8kk..8kk+7 of a 64-column accumulator
// rounded to bf16 in pairs are the register A fragment of the k16 step kk
// (FA3's convert_layout_acc_Aregs), so p and ds never leave registers.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "flash_common.cuh"

namespace dl4j_flash {
namespace hopper {

constexpr int kConsumerThreads = 256;  // warpgroups 0 and 1
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = 384;          // + the producer warpgroup
constexpr int kRows = 64;              // rows a consumer warpgroup owns; rows of a streamed tile
constexpr int kBlockRows = 128;        // rows a block owns
constexpr int kStages = 3;             // streamed tiles in flight
constexpr int kProducerRegs = 24;      // 128 x 24 + 256 x 240 = 384 x 168, the launch's share
constexpr int kConsumerRegs = 240;
constexpr int kChunkBytes = kRows * 64 * 2;  // one [64][64] bf16 chunk
constexpr float kLog2e = 1.4426950408889634f;

// The wgmma route (K5, K6, K7) takes bf16 operands whose head width pads
// to 64 or 128 and whose rows are whole 16-byte units (TMA's row stride).
inline bool wgmma_route(int is_bf16, int d) {
  return is_bf16 && d > 32 && d <= 128 && d % 8 == 0;
}

// ------------------------------------------------------------ shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The thread's warpgroup, broadcast from lane 0 so that the compiler sees
// a warp-uniform value: the role branch on it is then known not to diverge
// inside a warp, which setmaxnreg's register budgets rely on.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// A consumer warp's release of a stage: one arrival a warp (the empty
// barriers count kConsumerWarps), after all its lanes are done with it.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The producer's arrival, announcing the bytes its copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a copy that faulted, a miscounted arrival) traps after about
// ten seconds, so the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000ll) __trap();
}

// One 64 x 64 box of a [bh, T, d] bf16 tensor (columns c, rows r of bh b)
// into shared memory; rows or columns past the tensor's end arrive as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                         int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(b)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// f(a, b) with both flags as compile-time constants (std::true_type or
// std::false_type): a loop over a tile's cells is compiled once for each
// case instead of testing the flags in every cell.
template <typename F>
__device__ __forceinline__ void with_flags(bool a, bool b, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (a) {
    if (b) f(Y{}, Y{});
    else f(Y{}, N{});
  } else {
    if (b) f(N{}, Y{});
    else f(N{}, N{});
  }
}

// ------------------------------------------------------------------- wgmma
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (FA3's warpgroup_fence_operand). On a
// register A fragment it also keeps the registers holding it until the
// fence: a product still in flight reads them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 2^x on the special-function unit (one MUFU.EX2; 2^-huge is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// Matrix descriptor, 128-byte swizzle: start address, leading and stride
// byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k16 step ks of a 64-row tile read K-major (d contiguous).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * kChunkBytes + (ks & 3) * 32, 16, 1024);
}

// k16 step kk (rows 16kk..16kk+15) of 64-column chunk h of a tile read
// MN-major (rows are K).
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int h, int kk) {
  return sw128_desc(tile + h * kChunkBytes + kk * 2048, kChunkBytes, 1024);
}

// d[64 x 64] (+)= A . B, A and B from shared memory, both K-major; SA = -1
// negates A (K5 forms -s that way for a negative scale).
template <int SA = 1>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(SA));
}

// d[64 x 128] (+)= A . B, A and B from shared memory, both K-major (B 128
// rows of 128 bytes, 8-row groups SBO apart): K5's 128-key score tiles.
template <int SA = 1>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, %67, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(SA));
}

// d[64 x 64] += A . B, A the register fragment a[4] (64 x 16, bf16 pairs),
// B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A warpgroup's 64 x DP accumulator (DP/64 chunks of 64 columns), rounded
// to bf16, into rows row0 + 16w + g (+8) of a [*, d] output; rows < rows
// and columns < d only.
template <int NC>
__device__ __forceinline__ void store_acc(bf16* __restrict__ out, const float (&c)[NC][32],
                                          int row, int rows, int d, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    bf16* o = out + (size_t)(row + 8 * r) * d;
#pragma unroll
    for (int h = 0; h < NC; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * h + 8 * j + 2 * t;
        if (col < d)
          *reinterpret_cast<uint32_t*>(o + col) =
              pack_bf16(c[h][4 * j + 2 * r], c[h][4 * j + 2 * r + 1]);
      }
  }
}

// --------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime's
// entry-point query (the libraries are not linked against libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [bh, T, d] bf16 tensor as a TMA map of 64 x 64 boxes with the 128-byte
// swizzle; columns d..63 of a box (d < 64, or the second chunk of d < 128)
// and rows past T arrive as 0.
inline int make_map(CUtensorMap* map, const void* ptr, int bh, int T, int d) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace dl4j_flash

// 1 when the backward of bf16 operands with head width d takes the wgmma/TMA
// kernels, 0 when it takes the mma.sync bodies (f32, other widths).
extern "C" int dl4j_flash_bwd_wgmma(int is_bf16, int d) {
  return dl4j_flash::hopper::wgmma_route(is_bf16, d) ? 1 : 0;
}
