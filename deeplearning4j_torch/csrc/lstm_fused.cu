// K3: fused two-layer persistent LSTM forward, no step mask, with the BPTT
// reserve on the training path.
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/lstm_fused.py
// `_fwd2_kernel` (wrapper `_fwd2`): inference calls it with
// save_reserve=False (`_lstm2`), training with the reserve (`_lstm2_fwd`).
//
// What it computes, per step t (gate layout i|f|o|g, f32 accumulation):
//   z1 = xp[t] + bf16(h1) @ RW1                 -> cell -> h1, c1
//   z2 = b2 + bf16(h1) @ W2 + bf16(h2) @ RW2    -> cell -> h2, c2
//   ys2[t] = h2
// with the same cell (and optional Graves peepholes) as lstm_cell.cu. In
// inference the layer-1 output never goes to memory as a sequence (no
// ys1, no xp2). Training also writes ys1 (layer 1's h, which the backward
// needs for dW2 and dRW1), g1/g2 (post-activation i|f|o|g) and c1/c2 (the
// c sequences); each block writes its own units' reserve. The reserve is
// a template parameter (kReserve), so the serving instantiation carries no
// reserve code.
//
// What bounds it on an H100: the dependency chain again (two cells per
// step, each needing the whole previous h); the three [H, 4H] weights are
// 6 MB at H=512 bf16 and must not be streamed per step.
//
// Both bodies: one cooperative grid, the weights' gate columns of each
// block's units resident in shared memory, and the two layers as a
// wavefront: phase p computes layer 1 at step p and layer 2 at step p-1.
// Both need only h1_{p-1} and h2_{p-2}, which the previous phase
// published, so one grid.sync() per phase serves both layers: T+1 phases,
// not 2T. Two bodies, chosen statically by the C entry (dl4j_lstm2_fwd_tc
// names the choice):
//
// * Tensor cores (bf16 weights, B <= 64, H % 8 == 0, the grid resident):
//   K1's tensor-core body (lstm_cell.cu), with the layers on separate
//   blocks: 8 units a block, blocks [0, H/8) run layer 1 and [H/8, H/4)
//   layer 2 (128 blocks at H=512), 512 threads. A block's weight rows stay
//   in shared memory as rows of k (zeros past H): layer 1's 32 gate columns
//   of RW1, layer 2's 32 of W2 and 32 of RW2. The owner of each unit
//   publishes bf16(h1_p) or bf16(h2_{p-1}), rounded to nearest, once, to a
//   two-slot exchange hx [2 layers, 2 slots, B, H] (h0's h1 and h2 enter
//   the same way), so a block reads half the bytes of f32 and converts
//   nothing; ys1 and ys2 stay f32 outputs. After the barrier the products
//   run on `mma.sync` m16n8k16 (rows_product, lstm_hopper.cuh): layer 1
//   the h1 rows by RW1, layer 2 the h1 rows by W2 and the h2 rows by RW2
//   on two halves of its warps. Each warp takes an m-tile and every KG-th
//   32-wide chunk of k and leaves a partial tile; the cell threads, one
//   element (row, unit) each with its f32 h, c, peepholes (and b2) in
//   registers, add the tiles in warp order (no atomics), z2 as b2 + W2
//   part + RW2 part. Layer 1's xp[p] is copied into shared memory by
//   cp.async before the barrier, off the chain. Why separate blocks: at
//   b=64 a block that ran both layers read all of h1 and h2 each phase
//   (16 MB over 128 SMs, near L2's rate), and the products set the pace;
//   here only layer 2's blocks read both (12 MB), and the phase took 13%
//   less. At b=32 it took 3% more (PERF.md has both).
// * CUDA cores (f32 weights, and any shape the first does not take): HB
//   units a block, the smallest that keeps the grid resident; three weight
//   slices per block in shared memory (48 KB at H=512, HB=4, bf16). h1
//   crosses blocks through a two-slot f32 scratch buffer (slot p&1 written
//   in phase p, slot (p-1)&1 read), or through ys1 when the reserve is
//   written; h2 through ys2. After grid.sync() every block reads them back
//   through L2, converts them to the weights' type (load_h) and takes each
//   (row, column) dot product on CUDA cores (dot_col).
#include "lstm_common.cuh"
#include "lstm_hopper.cuh"

namespace dl4j {

template <typename W, bool kReserve>
__global__ void __launch_bounds__(kThreads)
lstm2_fwd_kernel(const float* __restrict__ xp,    // [T, B, 4H] layer-1 projection + bias
                 const W* __restrict__ rw1,       // [H, 4H]
                 const W* __restrict__ w2,        // [H, 4H]
                 const W* __restrict__ rw2,       // [H, 4H]
                 const float* __restrict__ b2,    // [4H]
                 const float* __restrict__ peep,  // [6, H] (layer 1 pi,pf,po; layer 2) or null
                 const float* __restrict__ h0,    // [4, B, H] (h1, c1, h2, c2)
                 float* hx,                       // [2, B, H] h1 exchange, or null with ys1
                 float* ys2,                      // [T, B, H]
                 float* ys1,                      // [T, B, H] reserve or null
                 float* __restrict__ g1,          // [T, B, 4H] reserve or null
                 float* __restrict__ c1,          // [T, B, H] reserve or null
                 float* __restrict__ g2,          // [T, B, 4H] reserve or null
                 float* __restrict__ c2,          // [T, B, H] reserve or null
                 float* __restrict__ hc,          // [4, B, H] final (h1, c1, h2, c2)
                 int T, int B, int H, int HB) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * HB;
  const size_t BH = (size_t)B * H;
  W* rw1_s = reinterpret_cast<W*>(smem);  // [H/8][G][8] each
  W* w2_s = rw1_s + (size_t)H * G;
  W* rw2_s = w2_s + (size_t)H * G;
  W* h1_s = rw2_s + (size_t)H * G;  // [B][H]
  W* h2_s = h1_s + BH;              // [B][H]
  float* z1_s = reinterpret_cast<float*>(h2_s + BH);  // [B][G]
  float* z2_s = z1_s + B * G;                         // [B][G]
  float* c1_s = z2_s + B * G;                         // [B][HB]
  float* c2_s = c1_s + B * HB;                        // [B][HB]
  const int u0 = blockIdx.x * HB;
  const float* p1 = peep;
  const float* p2 = peep ? peep + 3 * H : nullptr;

  load_gate_slice(rw1_s, rw1, H, HB, u0);
  load_gate_slice(w2_s, w2, H, HB, u0);
  load_gate_slice(rw2_s, rw2, H, HB, u0);
  for (int e = threadIdx.x; e < B * HB; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    c1_s[e] = h0[BH + at];
    c2_s[e] = h0[3 * BH + at];
  }

  for (int p = 0; p <= T; ++p) {
    const bool l1 = p < T, l2 = p >= 1;  // layer 1 at step p, layer 2 at step p-1
    const float* h1prev = p == 0 ? h0
                          : kReserve ? ys1 + (size_t)(p - 1) * BH
                                     : hx + ((p - 1) & 1) * BH;  // h1_{p-1}
    const float* h2prev = p < 2 ? h0 + 2 * BH : ys2 + (size_t)(p - 2) * BH;  // h2_{p-2}
    load_h(h1_s, h1prev, (int)BH);
    if (l2) load_h(h2_s, h2prev, (int)BH);
    __syncthreads();
    const float* xpt = xp + (size_t)p * B * 4 * H;
    for (int o = threadIdx.x; o < B * G; o += blockDim.x) {
      const int r = o / G, j = o % G;
      const int col = (j / HB) * H + u0 + j % HB;
      const W* h1r = h1_s + (size_t)r * H;
      if (l1) z1_s[o] = xpt[(size_t)r * 4 * H + col] + dot_col(h1r, rw1_s, H, G, j);
      if (l2)
        z2_s[o] = (b2[col] + dot_col(h1r, w2_s, H, G, j)) +
                  dot_col(h2_s + (size_t)r * H, rw2_s, H, G, j);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < B * HB; e += blockDim.x) {
      const int r = e / HB, u = e % HB, hu = u0 + u;
      const size_t at = (size_t)r * H + hu;
      if (l1) {
        const float* z = z1_s + r * G;
        CellOut s = cell(z[u], z[HB + u], z[2 * HB + u], z[3 * HB + u], c1_s[e], p1,
                         p1 ? p1 + H : nullptr, p1 ? p1 + 2 * H : nullptr, hu);
        c1_s[e] = s.c;
        if constexpr (kReserve) {
          ys1[(size_t)p * BH + at] = s.h;
          store_gates(g1 + ((size_t)p * B + r) * 4 * H, H, hu, s);
          c1[(size_t)p * BH + at] = s.c;
        } else {
          hx[(p & 1) * BH + at] = s.h;
        }
        if (p == T - 1) {
          hc[at] = s.h;
          hc[BH + at] = s.c;
        }
      }
      if (l2) {
        const float* z = z2_s + r * G;
        CellOut s = cell(z[u], z[HB + u], z[2 * HB + u], z[3 * HB + u], c2_s[e], p2,
                         p2 ? p2 + H : nullptr, p2 ? p2 + 2 * H : nullptr, hu);
        c2_s[e] = s.c;
        ys2[(size_t)(p - 1) * BH + at] = s.h;
        if constexpr (kReserve) {
          store_gates(g2 + ((size_t)(p - 1) * B + r) * 4 * H, H, hu, s);
          c2[(size_t)(p - 1) * BH + at] = s.c;
        }
        if (p == T) {
          hc[2 * BH + at] = s.h;
          hc[3 * BH + at] = s.c;
        }
      }
    }
    grid.sync();  // h1_p and h2_{p-1} are published; also a block barrier
  }
}

// Hidden units a block of the CUDA-core body (0 when no grid fits), and its
// dynamic shared memory.
template <typename W>
int fwd2_units(int B, int H, bool reserve, size_t* smem) {
  auto kernel = reserve ? lstm2_fwd_kernel<W, true> : lstm2_fwd_kernel<W, false>;
  auto smem_for = [&](int hb) {
    return (size_t)B * 10 * hb * sizeof(float) +
           ((size_t)3 * H * 4 * hb + (size_t)2 * B * H) * sizeof(W);
  };
  return pick_units_per_block(kernel, H, smem_for, smem);
}

template <typename W>
int launch2(const void* xp, const void* rw1, const void* w2, const void* rw2, const void* b2,
            const void* peep, const void* h0, void* hx, void* ys2, void* ys1, void* g1, void* c1,
            void* g2, void* c2, void* hc, int T, int B, int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = ys1 != nullptr ? lstm2_fwd_kernel<W, true> : lstm2_fwd_kernel<W, false>;
  size_t smem = 0;
  int HB = fwd2_units<W>(B, H, ys1 != nullptr, &smem);
  if (HB == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* xp_ = static_cast<const float*>(xp);
  const W* rw1_ = static_cast<const W*>(rw1);
  const W* w2_ = static_cast<const W*>(w2);
  const W* rw2_ = static_cast<const W*>(rw2);
  const float* b2_ = static_cast<const float*>(b2);
  const float* peep_ = static_cast<const float*>(peep);
  const float* h0_ = static_cast<const float*>(h0);
  float* hx_ = static_cast<float*>(hx);
  float* ys2_ = static_cast<float*>(ys2);
  float* ys1_ = static_cast<float*>(ys1);
  float* g1_ = static_cast<float*>(g1);
  float* c1_ = static_cast<float*>(c1);
  float* g2_ = static_cast<float*>(g2);
  float* c2_ = static_cast<float*>(c2);
  float* hc_ = static_cast<float*>(hc);
  void* args[] = {&xp_, &rw1_, &w2_, &rw2_, &b2_, &peep_, &h0_, &hx_, &ys2_, &ys1_,
                  &g1_, &c1_, &g2_, &c2_, &hc_, &T, &B, &H, &HB};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(H / HB), dim3(kThreads),
                                                args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- Tensor-core body (bf16 weights) ----

constexpr int kFwd2Units = 8;                // hidden units a block owns, of one layer
constexpr int kFwd2Cols = 4 * kFwd2Units;    // one weight's gate columns: four n-tiles of 8
constexpr int kFwd2Rows = 2 * kFwd2Cols;     // resident rows at most: W2 | RW2 (layer 2)
constexpr int kFwd2Stages = 3;               // 32-wide k chunks in flight a warp
constexpr int kFwd2Warps = kThreads / 32;    // 16
constexpr int kFwd2MaxKG = 4;                // warps sharing one product's m-tile
constexpr int kFwd2MaxB = 64;                // 4 m-tiles; B * kFwd2Units <= kThreads
constexpr int kFwd2Cells = kFwd2MaxB * kFwd2Units;  // cell threads a block at most
constexpr int kFwd2RingBytes = kFwd2Stages * kRowsStageBytes;

__host__ __device__ __forceinline__ int fwd2_chunks(int H) { return (H + 31) / 32; }

// Blocks of one layer; the grid has twice as many.
__host__ __device__ __forceinline__ int fwd2_blocks(int H) { return H / kFwd2Units; }

// Shared memory: a block's weight rows (padded row stride), each warp's
// ring (its partial tile reuses it), layer 1's staged xp.
__host__ __device__ __forceinline__ size_t fwd2_tc_smem(int H) {
  return (size_t)kFwd2Rows * padded_row(32 * fwd2_chunks(H)) * sizeof(__nv_bfloat16) +
         (size_t)kFwd2Warps * kFwd2RingBytes + (size_t)4 * kFwd2Cells * sizeof(float);
}

template <bool kReserve>
__global__ void __launch_bounds__(kThreads, 1)
lstm2_fwd_tc_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ rw1,
                    const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ rw2,
                    const float* __restrict__ b2, const float* __restrict__ peep,
                    const float* __restrict__ h0, __nv_bfloat16* hx, float* __restrict__ ys2,
                    float* __restrict__ ys1, float* __restrict__ g1, float* __restrict__ c1,
                    float* __restrict__ g2, float* __restrict__ c2, float* __restrict__ hc,
                    int T, int B, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HB = kFwd2Units;
  const int K4 = 4 * H, nch = fwd2_chunks(H), WP = padded_row(32 * nch), NB = fwd2_blocks(H);
  const size_t BH = (size_t)B * H;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [rows][WP]
  unsigned char* rings = smem + (size_t)kFwd2Rows * WP * sizeof(__nv_bfloat16);
  float* res_s = reinterpret_cast<float*>(rings + (size_t)kFwd2Warps * kFwd2RingBytes);
  __nv_bfloat16* x1 = hx;           // h1 slots [2][B][H]
  __nv_bfloat16* x2 = hx + 2 * BH;  // h2 slots [2][B][H]
  const int layer = blockIdx.x < NB ? 1 : 2;  // the same for the whole block
  const int u0 = (blockIdx.x % NB) * HB, tid = threadIdx.x, warp = tid / 32;

  // row gate * HB + unit of w_s is column gate * H + u0 + unit of RW1 (layer
  // 1), of W2 (layer 2; RW2's rows follow, from row kFwd2Cols)
  const int nrows = layer == 1 ? kFwd2Cols : 2 * kFwd2Cols;
  for (int i = tid; i < 32 * nch * nrows; i += blockDim.x) {
    const int k = i / nrows, j = i % nrows, jj = j % kFwd2Cols;
    const __nv_bfloat16* w = layer == 1 ? rw1 : j < kFwd2Cols ? w2 : rw2;
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (k < H) v = w[(size_t)k * K4 + (jj / HB) * H + u0 + jj % HB];
    w_s[(size_t)j * WP + k] = v;
  }

  // product roles: warps [0, MT * KG1) multiply the h1 rows (layer 1: by
  // RW1, layer 2: by W2), layer 2's next MT * KG2 the h2 rows by RW2; each
  // m-tile m and k chunks kg, kg + KG, ... Layer 1 at b <= 32 leaves warps
  // idle rather than add more partial tiles.
  const int MT = (B + 15) / 16, per_m = kFwd2Warps / MT;
  const int KG1 = min(layer == 1 ? per_m : per_m / 2, kFwd2MaxKG);
  const int KG2 = layer == 1 ? 0 : KG1;
  const bool h1_warp = warp < MT * KG1;
  const bool h2_warp = !h1_warp && warp < MT * (KG1 + KG2);
  const int pw = h1_warp ? warp : warp - MT * KG1;
  const int m = pw % MT, kg = pw / MT;
  unsigned char* ring = rings + (size_t)warp * kFwd2RingBytes;

  // cell role: element (row r, unit u) of the block's layer, its f32 h, c,
  // peepholes (and layer 2's b2) in registers
  const bool cell_on = tid < B * HB;
  const int r = tid / HB, u = tid % HB, hu = u0 + u;
  const size_t at = (size_t)r * H + hu;
  const bool peeps = peep != nullptr;
  float pv[3] = {0.0f, 0.0f, 0.0f}, bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h = 0.0f, c = 0.0f;
  if (cell_on) {
    const int l = layer - 1;
    if (peeps)
      for (int k = 0; k < 3; ++k) pv[k] = peep[(size_t)(3 * l + k) * H + hu];
    if (layer == 2)
      for (int j = 0; j < 4; ++j) bv[j] = b2[(size_t)j * H + hu];
    h = h0[(size_t)(2 * l) * BH + at];
    c = h0[(size_t)(2 * l + 1) * BH + at];
    (layer == 1 ? x1 : x2)[BH + at] = __float2bfloat16_rn(h);  // h_{-1}: slot 1
  }

  // Copy this layer-1 thread's xp[p] into res_s (one group, possibly empty).
  auto prefetch = [&](int p) {
    if (layer == 1 && cell_on && p < T) {
      const float* xrow = xp + ((size_t)p * B + r) * K4 + hu;
      for (int j = 0; j < 4; ++j)
        cp_async4_ca(res_s + j * kFwd2Cells + tid, xrow + (size_t)j * H);
    }
    cp_async_commit();
  };
  // a product's sum at (r, column col): its KG partial tiles in warp order,
  // the first on warp w0
  auto partial = [&](int w0, int KG, int col) {
    float s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < KG; ++k)
      s += reinterpret_cast<const float*>(rings + (size_t)(w0 + k * MT + r / 16) *
                                                      kFwd2RingBytes)[(r % 16) * kFwd2Cols + col];
    return s;
  };

  prefetch(0);
  for (int p = 0; p <= T; ++p) {
    // h1_{p-1} is in slot (p+1)&1 of x1 and h2_{p-2} in slot p&1 of x2;
    // also a block barrier
    grid.sync();
    const bool on = layer == 1 ? p < T : p >= 1;  // layer 1 at step p, layer 2 at p-1
    if (on && h1_warp)
      rows_product<kFwd2Cols / 8, kFwd2Stages>(x1 + (size_t)((p + 1) & 1) * BH, B, H, w_s, WP,
                                               kg, KG1, m, ring);
    else if (on && h2_warp)
      rows_product<kFwd2Cols / 8, kFwd2Stages>(x2 + (size_t)(p & 1) * BH, B, H,
                                               w_s + (size_t)kFwd2Cols * WP, WP, kg, KG2, m,
                                               ring);
    __syncthreads();     // the partial tiles are written
    cp_async_wait<0>();  // this thread's xp[p]
    if (on && cell_on) {
      const int t = layer == 1 ? p : p - 1;
      float z[4];
      for (int j = 0; j < 4; ++j)
        z[j] = layer == 1 ? res_s[j * kFwd2Cells + tid] + partial(0, KG1, j * HB + u)
                          : (bv[j] + partial(0, KG1, j * HB + u)) +
                                partial(MT * KG1, KG2, j * HB + u);
      CellOut s = cell(z[0], z[1], z[2], z[3], c, peeps ? &pv[0] : nullptr,
                       peeps ? &pv[1] : nullptr, peeps ? &pv[2] : nullptr, 0);
      h = s.h;
      c = s.c;
      if constexpr (kReserve) {
        float* gr = (layer == 1 ? g1 : g2) + ((size_t)t * B + r) * K4 + hu;
        gr[0] = s.i;
        gr[H] = s.f;
        gr[2 * H] = s.o;
        gr[3 * H] = s.g;
        (layer == 1 ? c1 : c2)[(size_t)t * BH + at] = c;
        if (layer == 1) ys1[(size_t)t * BH + at] = h;
      }
      if (layer == 2) ys2[(size_t)t * BH + at] = h;
      (layer == 1 ? x1 : x2)[(size_t)(t & 1) * BH + at] = __float2bfloat16_rn(h);
    }
    prefetch(p + 1);  // lands during the barrier and the products
  }
  if (cell_on) {  // layer 1 last ran at phase T-1, layer 2 at phase T
    hc[(size_t)(2 * (layer - 1)) * BH + at] = h;
    hc[(size_t)(2 * (layer - 1) + 1) * BH + at] = c;
  }
}

// Whether the tensor-core body takes this shape on the current device (and
// the kernel's shared-memory limit set for it): every block of the grid
// must be resident at once for the grid barrier.
bool fwd2_tc_fits(int B, int H, bool reserve) {
  if (H % 8 || H % kFwd2Units || B < 1 || B > kFwd2MaxB) return false;
  auto kernel = reserve ? lstm2_fwd_tc_kernel<true> : lstm2_fwd_tc_kernel<false>;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = fwd2_tc_smem(H);
  if (smem > (size_t)max_smem) return false;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return false;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return false;
  return (long)per_sm * sms >= 2 * fwd2_blocks(H);
}

int launch2_tc(const void* xp, const void* rw1, const void* w2, const void* rw2, const void* b2,
               const void* peep, const void* h0, void* hx, void* ys2, void* ys1, void* g1,
               void* c1, void* g2, void* c2, void* hc, int T, int B, int H,
               cudaStream_t stream) {
  auto kernel = ys1 != nullptr ? lstm2_fwd_tc_kernel<true> : lstm2_fwd_tc_kernel<false>;
  const float* xp_ = static_cast<const float*>(xp);
  const __nv_bfloat16* rw1_ = static_cast<const __nv_bfloat16*>(rw1);
  const __nv_bfloat16* w2_ = static_cast<const __nv_bfloat16*>(w2);
  const __nv_bfloat16* rw2_ = static_cast<const __nv_bfloat16*>(rw2);
  const float* b2_ = static_cast<const float*>(b2);
  const float* peep_ = static_cast<const float*>(peep);
  const float* h0_ = static_cast<const float*>(h0);
  __nv_bfloat16* hx_ = static_cast<__nv_bfloat16*>(hx);
  float* ys2_ = static_cast<float*>(ys2);
  float* ys1_ = static_cast<float*>(ys1);
  float* g1_ = static_cast<float*>(g1);
  float* c1_ = static_cast<float*>(c1);
  float* g2_ = static_cast<float*>(g2);
  float* c2_ = static_cast<float*>(c2);
  float* hc_ = static_cast<float*>(hc);
  void* args[] = {&xp_, &rw1_, &w2_, &rw2_, &b2_, &peep_, &h0_, &hx_, &ys2_,
                  &ys1_, &g1_, &c1_, &g2_, &c2_, &hc_, &T, &B, &H};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * fwd2_blocks(H)),
                                                dim3(kThreads), args, fwd2_tc_smem(H), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dl4j

// Plain C entry bound with ctypes. w_bf16 selects the type of rw1/w2/rw2
// (bf16 or f32); hxb [2, 2, B, H] bf16 is the tensor-core body's exchange of
// h1 and h2 (may be null for f32 weights); every other tensor is f32 and
// contiguous. Inference passes hx [2, B, H] (the CUDA-core body's h1
// exchange) and null reserves; training passes ys1, g1, c1, g2, c2 and a
// null hx. bf16 weights at a shape the tensor-core body takes launch it
// (dl4j_lstm2_fwd_tc), everything else the CUDA-core body. Returns a
// cudaError_t (0 on success).
extern "C" int dl4j_lstm2_fwd(const void* xp, const void* rw1, const void* w2, const void* rw2,
                              int w_bf16, const void* b2, const void* peep, const void* h0,
                              void* hx, void* hxb, void* ys2, void* ys1, void* g1, void* c1,
                              void* g2, void* c2, void* hc, int T, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16 && dl4j::fwd2_tc_fits(B, H, ys1 != nullptr))
    return dl4j::launch2_tc(xp, rw1, w2, rw2, b2, peep, h0, hxb, ys2, ys1, g1, c1, g2, c2, hc, T,
                            B, H, s);
  if (w_bf16)
    return dl4j::launch2<__nv_bfloat16>(xp, rw1, w2, rw2, b2, peep, h0, hx, ys2, ys1, g1, c1, g2,
                                        c2, hc, T, B, H, s);
  return dl4j::launch2<float>(xp, rw1, w2, rw2, b2, peep, h0, hx, ys2, ys1, g1, c1, g2, c2, hc, T,
                              B, H, s);
}

// 1 when dl4j_lstm2_fwd takes the tensor-core body for these weights, this
// shape and this instantiation (reserve: the training one) on the current
// device, 0 when the CUDA-core body.
extern "C" int dl4j_lstm2_fwd_tc(int w_bf16, int B, int H, int reserve) {
  return w_bf16 && dl4j::fwd2_tc_fits(B, H, reserve != 0) ? 1 : 0;
}

// Hidden units a block of the body dl4j_lstm2_fwd launches for these
// weights, this shape and this instantiation on the current device (0 when
// no grid fits). The CUDA-core body's grid has H / units blocks, each
// running both layers; the tensor-core body's 2 * H / units, half of them
// running layer 1 and half layer 2.
extern "C" int dl4j_lstm2_fwd_units(int w_bf16, int B, int H, int reserve) {
  size_t smem = 0;
  if (w_bf16 && dl4j::fwd2_tc_fits(B, H, reserve != 0)) return dl4j::kFwd2Units;
  return w_bf16 ? dl4j::fwd2_units<__nv_bfloat16>(B, H, reserve != 0, &smem)
                : dl4j::fwd2_units<float>(B, H, reserve != 0, &smem);
}
