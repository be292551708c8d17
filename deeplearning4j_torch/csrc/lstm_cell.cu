// K1: persistent LSTM forward for one layer, with the BPTT reserve on the
// training path.
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/lstm_cell.py
// `_fwd_kernel` (wrapper `_fwd`): inference calls it with
// save_reserve=False (`_lstm`), training with the reserve (`_lstm_fwd`).
//
// What it computes, per step t (time-major, gate layout i|f|o|g):
//   z = xp[t] + bf16(h) @ RW          (f32 accumulation; h, c stay f32)
//   zi += c*pi; zf += c*pf; c' = sig(zf)*c + sig(zi)*tanh(zg)
//   zo += c'*po; h' = sig(zo)*tanh(c')          (peepholes optional)
//   h = m*h' + (1-m)*h; c = m*c' + (1-m)*c      (fractional mask optional)
//   ys[t] = h
// and, in the training instantiation (kReserve), gates[t] = the
// post-activation i|f|o|g and cseq[t] = the post-mask c. The block that
// owns a unit writes its reserve, so the reserve costs no exchange. The
// serving instantiation has no reserve code at all: a runtime null check
// per cell cost the serving launch 2-3% on an H100 (PERF.md, findings).
//
// What bounds it on an H100: not bytes or FLOPs (at b=32, H=512 a step is
// 33 MFLOP and RW is 2 MB) but the dependency chain: step t needs all of
// h_{t-1}. Streaming RW from memory every step would cost T x 2 MB; the
// design keeps it out of memory instead.
//
// Both bodies: one cooperative grid, alive for the whole sequence, one
// grid.sync() a step. Each block holds its units' gate columns of RW in
// shared memory and owns h and c of its units; only h crosses blocks. Two
// bodies, chosen statically by the C entry (dl4j_lstm_fwd_tc names the
// choice):
//
// * Tensor cores (bf16 weights, B <= 64, H % 8 == 0, the grid resident):
//   4 units a block (128 blocks at H=512; 8 units and 64 blocks were
//   slower), 512 threads; the block's 16 gate columns of RW stay in shared
//   memory as two n-tiles of 8 rows of k (zeros past H). The owner of each
//   unit publishes bf16(h_t), rounded to nearest, once, to a two-slot
//   exchange hx [2, B, H] (h0 enters the same way), so every block reads
//   half the bytes of the f32 ys and converts nothing; ys stays the f32
//   output. After the barrier the products run on `mma.sync` m16n8k16
//   (rows_product, lstm_hopper.cuh): A = 16 rows of h through a
//   cp.async.cg ring, B = 8 resident gate columns. Warp w < MT * KG takes
//   m-tile w % MT and every KG-th 32-wide chunk of k (MT = ceil(B/16),
//   KG = min(16/MT, 4)) and leaves a [16 x 16] partial tile; the cell
//   threads, one element (row, unit) each with its f32 h and c in
//   registers (the mask's blend uses that f32 h), add the tiles in warp
//   order (no atomics). Each thread's xp[t] (and mask[t]) is copied into
//   shared memory by cp.async before the barrier, off the chain.
// * CUDA cores (f32 weights, and any shape the first does not take): HB
//   units a block, the smallest that keeps the grid resident; its [H, 4*HB]
//   slice of RW in shared memory (16 KB at H=512, HB=4, bf16); h_t is
//   published by writing ys[t], and after grid.sync() every block reads
//   ys[t-1] back through L2, converts it to the weights' type (load_h) and
//   takes each (row, column) dot product on CUDA cores (dot_col).
#include "lstm_common.cuh"
#include "lstm_hopper.cuh"

namespace dl4j {

template <typename W, bool kReserve>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xp,    // [T, B, 4H]
                const W* __restrict__ rw,        // [H, 4H]
                const float* __restrict__ peep,  // [3, H] (pi, pf, po) or null
                const float* __restrict__ mask,  // [T, B] or null
                const float* __restrict__ h0,    // [B, H]
                const float* __restrict__ c0,    // [B, H]
                float* ys,                       // [T, B, H]
                float* __restrict__ gates,       // [T, B, 4H] reserve or null
                float* __restrict__ cseq,        // [T, B, H] reserve or null
                float* __restrict__ hT,          // [B, H]
                float* __restrict__ cT,          // [B, H]
                int T, int B, int H, int HB) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 4 * HB;
  W* rw_s = reinterpret_cast<W*>(smem);         // [H/8][G][8]
  W* h_s = rw_s + (size_t)H * G;                // [B][H]
  float* z_s = reinterpret_cast<float*>(h_s + (size_t)B * H);  // [B][G]
  float* c_s = z_s + B * G;                     // [B][HB]
  const int u0 = blockIdx.x * HB;
  const float* pi = peep ? peep : nullptr;
  const float* pf = peep ? peep + H : nullptr;
  const float* po = peep ? peep + 2 * H : nullptr;

  load_gate_slice(rw_s, rw, H, HB, u0);
  for (int e = threadIdx.x; e < B * HB; e += blockDim.x)
    c_s[e] = c0[(e / HB) * H + u0 + e % HB];

  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    load_h(h_s, hprev, B * H);
    __syncthreads();
    const float* xpt = xp + (size_t)t * B * 4 * H;
    for (int o = threadIdx.x; o < B * G; o += blockDim.x) {
      const int r = o / G, j = o % G;
      const int col = (j / HB) * H + u0 + j % HB;
      z_s[o] = xpt[(size_t)r * 4 * H + col] + dot_col(h_s + (size_t)r * H, rw_s, H, G, j);
    }
    __syncthreads();
    float* yst = ys + (size_t)t * B * H;
    for (int e = threadIdx.x; e < B * HB; e += blockDim.x) {
      const int r = e / HB, u = e % HB, hu = u0 + u;
      const float* z = z_s + r * G;
      const float c = c_s[e];
      CellOut s = cell(z[u], z[HB + u], z[2 * HB + u], z[3 * HB + u], c, pi, pf, po, hu);
      if constexpr (kReserve) store_gates(gates + ((size_t)t * B + r) * 4 * H, H, hu, s);
      if (mask != nullptr) {
        const float m = mask[(size_t)t * B + r];
        s.h = m * s.h + (1.0f - m) * __ldcg(hprev + (size_t)r * H + hu);
        s.c = m * s.c + (1.0f - m) * c;
      }
      c_s[e] = s.c;
      yst[(size_t)r * H + hu] = s.h;
      if constexpr (kReserve) cseq[(size_t)t * B * H + (size_t)r * H + hu] = s.c;
      if (t == T - 1) {
        hT[(size_t)r * H + hu] = s.h;
        cT[(size_t)r * H + hu] = s.c;
      }
    }
    grid.sync();  // h_t is complete in ys[t]; also a block barrier
  }
}

// Hidden units a block of the CUDA-core body (0 when no grid fits), and its
// dynamic shared memory.
template <typename W>
int fwd_units(int B, int H, bool reserve, size_t* smem) {
  auto kernel = reserve ? lstm_fwd_kernel<W, true> : lstm_fwd_kernel<W, false>;
  auto smem_for = [&](int hb) {
    return (size_t)B * 5 * hb * sizeof(float) + ((size_t)H * 4 * hb + (size_t)B * H) * sizeof(W);
  };
  return pick_units_per_block(kernel, H, smem_for, smem);
}

template <typename W>
int launch(const void* xp, const void* rw, const void* peep, const void* mask, const void* h0,
           const void* c0, void* ys, void* gates, void* cseq, void* hT, void* cT, int T, int B,
           int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = gates != nullptr ? lstm_fwd_kernel<W, true> : lstm_fwd_kernel<W, false>;
  size_t smem = 0;
  int HB = fwd_units<W>(B, H, gates != nullptr, &smem);
  if (HB == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* xp_ = static_cast<const float*>(xp);
  const W* rw_ = static_cast<const W*>(rw);
  const float* peep_ = static_cast<const float*>(peep);
  const float* mask_ = static_cast<const float*>(mask);
  const float* h0_ = static_cast<const float*>(h0);
  const float* c0_ = static_cast<const float*>(c0);
  float* ys_ = static_cast<float*>(ys);
  float* gates_ = static_cast<float*>(gates);
  float* cseq_ = static_cast<float*>(cseq);
  float* hT_ = static_cast<float*>(hT);
  float* cT_ = static_cast<float*>(cT);
  void* args[] = {&xp_, &rw_, &peep_, &mask_, &h0_, &c0_, &ys_,
                  &gates_, &cseq_, &hT_, &cT_, &T, &B, &H, &HB};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(H / HB), dim3(kThreads),
                                                args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- Tensor-core body (bf16 weights) ----

constexpr int kFwdUnits = 4;               // hidden units a block owns
constexpr int kFwdCols = 4 * kFwdUnits;    // their gate columns: n-tiles of 8
constexpr int kFwdStages = 3;              // 32-wide k chunks in flight a warp
constexpr int kFwdWarps = kThreads / 32;   // 16
constexpr int kFwdMaxKG = 4;               // warps sharing an m-tile's k chunks
constexpr int kFwdMaxB = 64;               // 4 m-tiles; B * kFwdUnits <= kThreads
constexpr int kFwdStaged = 5;             // per-step floats a thread: xp i, f, o, g and m
constexpr int kFwdRingBytes = kFwdStages * kRowsStageBytes;

__host__ __device__ __forceinline__ int fwd_chunks(int H) { return (H + 31) / 32; }

// Shared memory: the block's gate columns as rows of k (padded row stride),
// each warp's ring (its partial tile reuses it), each thread's xp and mask.
__host__ __device__ __forceinline__ size_t fwd_tc_smem(int H) {
  return (size_t)kFwdCols * padded_row(32 * fwd_chunks(H)) * sizeof(__nv_bfloat16) +
         (size_t)kFwdWarps * kFwdRingBytes + (size_t)kFwdStaged * kThreads * sizeof(float);
}

template <bool kReserve>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_tc_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ rw,
                   const float* __restrict__ peep, const float* __restrict__ mask,
                   const float* __restrict__ h0, const float* __restrict__ c0,
                   __nv_bfloat16* hx, float* __restrict__ ys, float* __restrict__ gates,
                   float* __restrict__ cseq, float* __restrict__ hT, float* __restrict__ cT,
                   int T, int B, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HB = kFwdUnits;
  const int K4 = 4 * H, nch = fwd_chunks(H), WP = padded_row(32 * nch);
  const size_t BH = (size_t)B * H;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kFwdCols][WP]
  unsigned char* rings = smem + (size_t)kFwdCols * WP * sizeof(__nv_bfloat16);
  float* res_s = reinterpret_cast<float*>(rings + (size_t)kFwdWarps * kFwdRingBytes);
  const int u0 = blockIdx.x * HB, tid = threadIdx.x, warp = tid / 32;

  // row j = gate * HB + unit of w_s is RW's column gate * H + u0 + unit
  for (int i = tid; i < 32 * nch * kFwdCols; i += blockDim.x) {
    const int k = i / kFwdCols, j = i % kFwdCols;
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (k < H) v = rw[(size_t)k * K4 + (j / HB) * H + u0 + j % HB];
    w_s[(size_t)j * WP + k] = v;
  }

  // product role: m-tile m, k chunks kg, kg + KG, ... (at most kFwdMaxKG
  // partial tiles to add: fewer were faster at b=32 than all 16 warps)
  const int MT = (B + 15) / 16, KG = min(kFwdWarps / MT, kFwdMaxKG);
  const int m = warp % MT, kg = warp / MT;
  const bool mma_warp = warp < MT * KG;
  unsigned char* ring = rings + (size_t)warp * kFwdRingBytes;

  // cell role: element (row r, unit u), its h and c in registers
  const bool cell_on = tid < B * HB;
  const int r = tid / HB, u = tid % HB, hu = u0 + u;
  const size_t at = (size_t)r * H + hu;
  const bool peeps = peep != nullptr, masked = mask != nullptr;
  float pv[3] = {0.0f, 0.0f, 0.0f}, h = 0.0f, c = 0.0f;
  if (cell_on) {
    if (peeps)
      for (int k = 0; k < 3; ++k) pv[k] = peep[(size_t)k * H + hu];
    h = h0[at];
    c = c0[at];
    hx[BH + at] = __float2bfloat16_rn(h);  // h_{-1}: slot 1
  }

  // Copy this thread's xp[t] (and mask[t]) into res_s (one group, possibly empty).
  auto prefetch = [&](int t) {
    if (cell_on && t < T) {
      const float* xrow = xp + ((size_t)t * B + r) * K4 + hu;
      for (int j = 0; j < 4; ++j) cp_async4_ca(res_s + j * kThreads + tid, xrow + (size_t)j * H);
      if (masked) cp_async4_ca(res_s + 4 * kThreads + tid, mask + (size_t)t * B + r);
    }
    cp_async_commit();
  };
  // the product at (r, column col): the KG partial tiles in warp order
  auto partial = [&](int col) {
    float s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < KG; ++k)
      s += reinterpret_cast<const float*>(rings + (size_t)(k * MT + r / 16) *
                                                      kFwdRingBytes)[(r % 16) * kFwdCols + col];
    return s;
  };

  prefetch(0);
  for (int t = 0; t < T; ++t) {
    grid.sync();  // h_{t-1} is in slot (t+1)&1; also a block barrier
    if (mma_warp)
      rows_product<kFwdCols / 8, kFwdStages>(hx + (size_t)((t + 1) & 1) * BH, B, H, w_s, WP,
                                             kg, KG, m, ring);
    __syncthreads();     // the partial tiles are written
    cp_async_wait<0>();  // this thread's xp[t] and mask[t]
    if (cell_on) {
      float z[4];
      for (int j = 0; j < 4; ++j) z[j] = res_s[j * kThreads + tid] + partial(j * HB + u);
      CellOut s = cell(z[0], z[1], z[2], z[3], c, peeps ? &pv[0] : nullptr,
                       peeps ? &pv[1] : nullptr, peeps ? &pv[2] : nullptr, 0);
      if constexpr (kReserve) {
        float* gr = gates + ((size_t)t * B + r) * K4 + hu;
        gr[0] = s.i;
        gr[H] = s.f;
        gr[2 * H] = s.o;
        gr[3 * H] = s.g;
      }
      if (masked) {
        const float mv = res_s[4 * kThreads + tid];
        s.h = mv * s.h + (1.0f - mv) * h;
        s.c = mv * s.c + (1.0f - mv) * c;
      }
      h = s.h;
      c = s.c;
      ys[(size_t)t * BH + at] = h;
      hx[(size_t)(t & 1) * BH + at] = __float2bfloat16_rn(h);
      if constexpr (kReserve) cseq[(size_t)t * BH + at] = c;
    }
    prefetch(t + 1);  // lands during the barrier and the products
  }
  if (cell_on) {
    hT[at] = h;
    cT[at] = c;
  }
}

// Whether the tensor-core body takes this shape on the current device (and
// the kernel's shared-memory limit set for it): every block of the grid
// must be resident at once for the grid barrier.
bool fwd_tc_fits(int B, int H, bool reserve) {
  if (H % 8 || H % kFwdUnits || B < 1 || B > kFwdMaxB) return false;
  auto kernel = reserve ? lstm_fwd_tc_kernel<true> : lstm_fwd_tc_kernel<false>;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = fwd_tc_smem(H);
  if (smem > (size_t)max_smem) return false;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return false;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return false;
  return (long)per_sm * sms >= H / kFwdUnits;
}

int launch_tc(const void* xp, const void* rw, const void* peep, const void* mask, const void* h0,
              const void* c0, void* hx, void* ys, void* gates, void* cseq, void* hT, void* cT,
              int T, int B, int H, cudaStream_t stream) {
  auto kernel = gates != nullptr ? lstm_fwd_tc_kernel<true> : lstm_fwd_tc_kernel<false>;
  const float* xp_ = static_cast<const float*>(xp);
  const __nv_bfloat16* rw_ = static_cast<const __nv_bfloat16*>(rw);
  const float* peep_ = static_cast<const float*>(peep);
  const float* mask_ = static_cast<const float*>(mask);
  const float* h0_ = static_cast<const float*>(h0);
  const float* c0_ = static_cast<const float*>(c0);
  __nv_bfloat16* hx_ = static_cast<__nv_bfloat16*>(hx);
  float* ys_ = static_cast<float*>(ys);
  float* gates_ = static_cast<float*>(gates);
  float* cseq_ = static_cast<float*>(cseq);
  float* hT_ = static_cast<float*>(hT);
  float* cT_ = static_cast<float*>(cT);
  void* args[] = {&xp_, &rw_, &peep_, &mask_, &h0_, &c0_, &hx_, &ys_,
                  &gates_, &cseq_, &hT_, &cT_, &T, &B, &H};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(H / kFwdUnits),
                                                dim3(kThreads), args, fwd_tc_smem(H), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dl4j

// Plain C entry bound with ctypes. rw_bf16 selects the weights' type
// (bf16 or f32); hx [2, B, H] bf16 is the tensor-core body's h exchange
// (may be null for f32 weights); every other tensor is f32 and contiguous;
// gates and cseq are both set (training) or both null (inference). bf16
// weights at a shape the tensor-core body takes launch it
// (dl4j_lstm_fwd_tc), everything else the CUDA-core body. Returns a
// cudaError_t (0 on success).
extern "C" int dl4j_lstm_fwd(const void* xp, const void* rw, int rw_bf16, const void* peep,
                             const void* mask, const void* h0, const void* c0, void* hx, void* ys,
                             void* gates, void* cseq, void* hT, void* cT, int T, int B, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rw_bf16 && dl4j::fwd_tc_fits(B, H, gates != nullptr))
    return dl4j::launch_tc(xp, rw, peep, mask, h0, c0, hx, ys, gates, cseq, hT, cT, T, B, H, s);
  if (rw_bf16)
    return dl4j::launch<__nv_bfloat16>(xp, rw, peep, mask, h0, c0, ys, gates, cseq, hT, cT, T, B,
                                       H, s);
  return dl4j::launch<float>(xp, rw, peep, mask, h0, c0, ys, gates, cseq, hT, cT, T, B, H, s);
}

// 1 when dl4j_lstm_fwd takes the tensor-core body for these weights, this
// shape and this instantiation (reserve: the training one) on the current
// device, 0 when the CUDA-core body.
extern "C" int dl4j_lstm_fwd_tc(int w_bf16, int B, int H, int reserve) {
  return w_bf16 && dl4j::fwd_tc_fits(B, H, reserve != 0) ? 1 : 0;
}

// Hidden units a block of the body dl4j_lstm_fwd launches for these
// weights, this shape and this instantiation on the current device (the
// grid has H / units blocks; 0 when no grid fits).
extern "C" int dl4j_lstm_fwd_units(int w_bf16, int B, int H, int reserve) {
  size_t smem = 0;
  if (w_bf16 && dl4j::fwd_tc_fits(B, H, reserve != 0)) return dl4j::kFwdUnits;
  return w_bf16 ? dl4j::fwd_units<__nv_bfloat16>(B, H, reserve != 0, &smem)
                : dl4j::fwd_units<float>(B, H, reserve != 0, &smem);
}
