// K2: reverse-time BPTT of one persistent-LSTM layer (the backward of K1).
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/lstm_cell.py
// `_bwd_kernel` (wrapper `_bwd_call`, called by `_lstm_bwd`).
//
// What it computes, for t = T-1 .. 0, carrying (dh, dc) from dhT, dcT:
//   dh_tot = dy[t] + dh;  dc_tot = dc;  (times the step mask m when masked)
//   c_cand = cseq[t], or f*c_{t-1} + i*g when masked (cseq holds the
//            post-mask c, the forward's tanh/peephole used the candidate)
//   dz[t]  = the cell's pre-activation gradient (i|f|o|g), from the gates
//            reserve, c_cand and c_{t-1} (cseq[t-1], or c0 at t = 0)
//   dh     = bf16(dz[t]) . RW^T + (1-m)*dh_tot       (f32 accumulation)
//   dc     = dc_cand*f (+ dzi*pi + dzf*pf) + (1-m)*dc_tot
//   dpeep += sum over the batch of dzi*c_{t-1}, dzf*c_{t-1}, dzo*c_cand
// and writes dz, dh0 = dh, dc0 = dc and dpeep. dRW = sum_t h_{t-1}^T dz_t
// and dxp = dz are products over the whole sequence, formed outside.
//
// What bounds it on an H100: the dependency chain, as in the forward: step
// t-1 needs dz_t of every unit. The weights (2 MB at H=512 bf16) stay
// resident; the bytes that must move are the dy/reserve/dz streams.
//
// Both bodies use the cooperative grid of lstm_cell.cu (lstm_common.cuh).
// Block k owns some hidden units: their dc and dh carries, and dz for all
// four gate columns of them, computed locally. The exchanged operand is
// dz_t [B, 4H], four times the forward's h (256 KB at b=64 in bf16, more
// than a block's shared memory), so it is published in RW's type (exact:
// the reference casts dz to the weight dtype before the product) to a
// two-slot global buffer, read back after one grid.sync() a step. The
// peephole sums stay with the owning block and are added over the batch
// in a fixed order: no atomics, two launches are bitwise equal. Two
// bodies, chosen statically by the C entry (dl4j_lstm_bwd_tc names the
// choice):
//
// * Tensor cores (bf16 weights, B <= 64, H % 8 == 0, the grid resident):
//   K4's tensor-core body (lstm_fused_bwd.cu) with one weight and one cell
//   layer. 8 units a block (64 blocks at H=512), 512 threads, the block's 8
//   rows of RW resident (one n-tile). Every block reads all of dz_t: with
//   half K4's exchange, that was faster than clusters of two splitting k
//   (PERF.md). The products run on `mma.sync` m16n8k16
//   (rows_product, lstm_hopper.cuh): A = 16 dz rows through a cp.async.cg
//   ring, B = the 8 weight rows. Warp w takes m-tile w % MT and every
//   KG-th 32-wide chunk of k (MT = ceil(B/16), KG = 16/MT) and leaves a
//   [16 x 8] partial tile; the cell threads (one element (row, unit) each,
//   dh, dc and the peephole sums in registers) add the tiles in warp
//   order. Each thread's reserve for the next step (4 gates, cseq[t] or the
//   mask, c_{t-1}, dy) is copied into shared memory by cp.async before the
//   barrier, off the chain.
// * CUDA cores (f32 weights, and any shape the first does not take): HB
//   units a block; after grid.sync() each block reads dz through L2 in
//   8-wide chunks (row_dot) against its rows of RW, held in shared memory
//   as [HB][4H]; the reserve is read after the barrier.
#include "lstm_common.cuh"
#include "lstm_hopper.cuh"

namespace dl4j {

template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ dy,     // [T, B, H]
                const float* __restrict__ gates,  // [T, B, 4H] post-activation i|f|o|g
                const float* __restrict__ cseq,   // [T, B, H] post-mask c
                const W* __restrict__ rw,         // [H, 4H]
                const float* __restrict__ peep,   // [3, H] (pi, pf, po) or null
                const float* __restrict__ mask,   // [T, B] or null
                const float* __restrict__ c0,     // [B, H]
                const float* __restrict__ dhT,    // [B, H]
                const float* __restrict__ dcT,    // [B, H]
                W* dzx,                           // [2, B, 4H] dz exchange
                float* __restrict__ dz,           // [T, B, 4H]
                float* __restrict__ dh0,          // [B, H]
                float* __restrict__ dc0,          // [B, H]
                float* __restrict__ dpeep,        // [3, H] or null
                int T, int B, int H, int HB) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * H, E = B * HB;
  const size_t BH = (size_t)B * H, BK = (size_t)B * K;
  W* rw_s = reinterpret_cast<W*>(smem);                           // [HB][4H]
  float* dh_s = reinterpret_cast<float*>(rw_s + (size_t)HB * K);  // [B][HB]
  float* dc_s = dh_s + E;                                         // [B][HB]
  float* res_s = dc_s + E;  // (1-m)*dh_tot, the straight-through residual
  float* dp_s = res_s + E;  // [B*HB][3] peephole partial sums
  const int u0 = blockIdx.x * HB;
  const float* pi = peep;
  const float* pf = peep ? peep + H : nullptr;
  const float* po = peep ? peep + 2 * H : nullptr;

  load_unit_rows(rw_s, rw, H, HB, u0);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    dh_s[e] = dhT[at];
    dc_s[e] = dcT[at];
    dp_s[3 * e] = dp_s[3 * e + 1] = dp_s[3 * e + 2] = 0.0f;
  }
  const W* const w[1] = {rw_s};

  for (int t = T - 1; t >= 0; --t) {
    __syncthreads();  // dh_s of the previous product (or dhT) is complete
    W* xs = dzx + (size_t)(t & 1) * BK;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      const int r = e / HB, hu = u0 + e % HB;
      const size_t at = (size_t)r * H + hu;
      const float* g = gates + ((size_t)t * B + r) * K;
      const float gi = g[hu], gf = g[H + hu], go = g[2 * H + hu], gg = g[3 * H + hu];
      const float c_prev = t > 0 ? cseq[(size_t)(t - 1) * BH + at] : c0[at];
      const float dh_tot = dy[(size_t)t * BH + at] + dh_s[e];
      const float dc_tot = dc_s[e];
      float m = 1.0f, c_cand, dh_c = dh_tot, dc_c = dc_tot;
      if (mask != nullptr) {
        m = mask[(size_t)t * B + r];
        dh_c = m * dh_tot;
        dc_c = m * dc_tot;
        c_cand = gf * c_prev + gi * gg;
      } else {
        c_cand = cseq[(size_t)t * BH + at];
      }
      const CellGrad d = cell_bwd(gi, gf, go, gg, c_cand, c_prev, dh_c, dc_c, pi, pf, po, hu);
      float* dzr = dz + ((size_t)t * B + r) * K;
      dzr[hu] = d.dzi;
      dzr[H + hu] = d.dzf;
      dzr[2 * H + hu] = d.dzo;
      dzr[3 * H + hu] = d.dzg;
      W* xr = xs + (size_t)r * K;
      store_w(xr + hu, d.dzi);
      store_w(xr + H + hu, d.dzf);
      store_w(xr + 2 * H + hu, d.dzo);
      store_w(xr + 3 * H + hu, d.dzg);
      if (pi != nullptr) {
        dp_s[3 * e] += d.dzi * c_prev;
        dp_s[3 * e + 1] += d.dzf * c_prev;
        dp_s[3 * e + 2] += d.dzo * c_cand;
      }
      res_s[e] = (1.0f - m) * dh_tot;
      dc_s[e] = d.dc_prev + (1.0f - m) * dc_tot;
    }
    grid.sync();  // dz_t of every unit is in xs; also a block barrier
    // dh_{t-1} = bf16(dz_t) . RW^T for the block's units, plus the residual
    for (int it = threadIdx.x; it < dot_items(B); it += blockDim.x) {
      const int r = it / kSplit, s = it % kSplit;
      float acc[1][kMaxHB] = {};
      if (r < B) row_dot<W, 1>(xs + (size_t)r * K, w, K, HB, s, acc);
      lane_reduce<1>(acc);
      if (r < B && s < HB) {
        float v = 0.0f;
#pragma unroll
        for (int u = 0; u < kMaxHB; ++u)
          if (u == s) v = acc[0][u];
        dh_s[r * HB + s] = v + res_s[r * HB + s];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    dh0[at] = dh_s[e];
    dc0[at] = dc_s[e];
  }
  if (dpeep != nullptr) {
    for (int q = threadIdx.x; q < 3 * HB; q += blockDim.x) {
      const int k = q / HB, u = q % HB;
      float sum = 0.0f;
      for (int r = 0; r < B; ++r) sum += dp_s[3 * (r * HB + u) + k];
      dpeep[(size_t)k * H + u0 + u] = sum;
    }
  }
}

// Hidden units a block of the CUDA-core body (0 when no grid fits), and its
// dynamic shared memory.
template <typename W>
int bwd_units(int B, int H, size_t* smem) {
  auto smem_for = [&](int hb) {
    if (hb > kMaxHB) return (size_t)-1;  // row_dot keeps kMaxHB sums per thread
    return (size_t)hb * 4 * H * sizeof(W) + (size_t)B * hb * 6 * sizeof(float);
  };
  return pick_units_per_block(lstm_bwd_kernel<W>, H, smem_for, smem);
}

template <typename W>
int launch_bwd(const void* dy, const void* gates, const void* cseq, const void* rw,
               const void* peep, const void* mask, const void* c0, const void* dhT,
               const void* dcT, void* dzx, void* dz, void* dh0, void* dc0, void* dpeep, int T,
               int B, int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_bwd_kernel<W>;
  size_t smem = 0;
  int HB = bwd_units<W>(B, H, &smem);
  if (HB == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* dy_ = static_cast<const float*>(dy);
  const float* gates_ = static_cast<const float*>(gates);
  const float* cseq_ = static_cast<const float*>(cseq);
  const W* rw_ = static_cast<const W*>(rw);
  const float* peep_ = static_cast<const float*>(peep);
  const float* mask_ = static_cast<const float*>(mask);
  const float* c0_ = static_cast<const float*>(c0);
  const float* dhT_ = static_cast<const float*>(dhT);
  const float* dcT_ = static_cast<const float*>(dcT);
  W* dzx_ = static_cast<W*>(dzx);
  float* dz_ = static_cast<float*>(dz);
  float* dh0_ = static_cast<float*>(dh0);
  float* dc0_ = static_cast<float*>(dc0);
  float* dpeep_ = static_cast<float*>(dpeep);
  void* args[] = {&dy_, &gates_, &cseq_, &rw_, &peep_, &mask_, &c0_, &dhT_, &dcT_,
                  &dzx_, &dz_, &dh0_, &dc0_, &dpeep_, &T, &B, &H, &HB};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(H / HB), dim3(kThreads),
                                                args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- Tensor-core body (bf16 weights) ----

constexpr int kBwdUnits = 8;                // hidden units a block owns: one n-tile
constexpr int kBwdStages = 3;               // 32-wide k chunks in flight a warp
constexpr int kBwdWarps = kThreads / 32;    // 16
constexpr int kBwdMaxB = 64;                // 4 m-tiles; B * kBwdUnits <= kThreads
constexpr int kBwdReserve = 8;              // reserve floats a thread: i, f, o, g, c, c_prev, dy, m
constexpr int kBwdRingBytes = kBwdStages * kRowsStageBytes;
static_assert(kBwdMaxB * kBwdUnits <= kThreads, "a thread for each cell");

// Shared memory: the block's 8 rows of RW (padded row stride), each warp's
// ring (its partial tile and, at the end, the peephole sums reuse it), each
// thread's reserve.
__host__ __device__ __forceinline__ size_t bwd_tc_smem(int H) {
  return (size_t)kBwdUnits * padded_row(4 * H) * sizeof(__nv_bfloat16) +
         (size_t)kBwdWarps * kBwdRingBytes + (size_t)kBwdReserve * kThreads * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_tc_kernel(const float* __restrict__ dy, const float* __restrict__ gates,
                   const float* __restrict__ cseq, const __nv_bfloat16* __restrict__ rw,
                   const float* __restrict__ peep, const float* __restrict__ mask,
                   const float* __restrict__ c0, const float* __restrict__ dhT,
                   const float* __restrict__ dcT, __nv_bfloat16* dzx, float* __restrict__ dz,
                   float* __restrict__ dh0, float* __restrict__ dc0, float* __restrict__ dpeep,
                   int T, int B, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HB = kBwdUnits;
  const int K = 4 * H, WP = padded_row(K);
  const size_t BH = (size_t)B * H, BK = (size_t)B * K;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [HB][WP]
  unsigned char* rings = smem + (size_t)HB * WP * sizeof(__nv_bfloat16);
  float* res_s = reinterpret_cast<float*>(rings + (size_t)kBwdWarps * kBwdRingBytes);
  const int u0 = blockIdx.x * HB, tid = threadIdx.x, warp = tid / 32;

  // the block's units' rows of RW
  for (int i = tid; i < HB * K / 8; i += blockDim.x) {
    const int row = i / (K / 8), k = 8 * (i % (K / 8));
    *reinterpret_cast<uint4*>(w_s + (size_t)row * WP + k) =
        __ldg(reinterpret_cast<const uint4*>(rw + (size_t)(u0 + row) * K + k));
  }

  // product role: m-tile m, k chunks kg, kg + KG, ...
  const int MT = (B + 15) / 16, KG = kBwdWarps / MT;
  const int m = warp % MT, kg = warp / MT;
  const bool mma_warp = warp < MT * KG;
  unsigned char* ring = rings + (size_t)warp * kBwdRingBytes;

  // cell role: element (row r, unit u)
  const bool cell_on = tid < B * HB;
  const int r = tid / HB, u = tid % HB, hu = u0 + u;
  const size_t at = (size_t)r * H + hu;
  const bool peeps = peep != nullptr, masked = mask != nullptr;
  float pv[3] = {0.0f, 0.0f, 0.0f}, dp[3] = {0.0f, 0.0f, 0.0f};
  float dh = 0.0f, dc = 0.0f, resid = 0.0f;  // resid: (1-m)*dh_tot of the step after
  if (cell_on) {
    if (peeps)
      for (int k = 0; k < 3; ++k) pv[k] = peep[(size_t)k * H + hu];
    dh = dhT[at];
    dc = dcT[at];
  }

  // Copy this thread's reserve for step t into res_s (one group, possibly empty).
  auto prefetch = [&](int t) {
    if (cell_on && t >= 0) {
      const float* grow = gates + ((size_t)t * B + r) * K + hu;
      for (int j = 0; j < 4; ++j) cp_async4_ca(res_s + j * kThreads + tid, grow + (size_t)j * H);
      if (!masked) cp_async4_ca(res_s + 4 * kThreads + tid, cseq + (size_t)t * BH + at);
      cp_async4_ca(res_s + 5 * kThreads + tid, t > 0 ? cseq + (size_t)(t - 1) * BH + at : c0 + at);
      cp_async4_ca(res_s + 6 * kThreads + tid, dy + (size_t)t * BH + at);
      if (masked) cp_async4_ca(res_s + 7 * kThreads + tid, mask + (size_t)t * B + r);
    }
    cp_async_commit();
  };
  // bf16(dz) . RW^T at (r, u) from the exchange slot: the KG partial tiles
  // added in warp order (the same order in every launch)
  auto product = [&](int slot) {
    if (mma_warp)
      rows_product<1, kBwdStages>(dzx + (size_t)slot * BK, B, K, w_s, WP, kg, KG, m, ring);
    __syncthreads();  // the partial tiles are written
    float s = 0.0f;
    if (cell_on) {
#pragma unroll 4
      for (int k = 0; k < KG; ++k)
        s += reinterpret_cast<const float*>(rings + (size_t)(k * MT + r / 16) *
                                                        kBwdRingBytes)[(r % 16) * HB + u];
    }
    return s;
  };

  prefetch(T - 1);
  __syncthreads();  // the weight rows are resident
  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) {
      grid.sync();  // dz_{t+1} is published; also a block barrier (the tiles are free)
      dh = product((t + 1) & 1) + resid;
    }
    cp_async_wait<0>();  // this thread's reserve for step t
    if (cell_on) {
      float rv[kBwdReserve];
      for (int j = 0; j < kBwdReserve; ++j) rv[j] = res_s[j * kThreads + tid];
      const float c_prev = rv[5], dh_tot = rv[6] + dh, dc_tot = dc;
      float mv = 1.0f, c_cand = rv[4], dh_c = dh_tot, dc_c = dc_tot;
      if (masked) {
        mv = rv[7];
        dh_c = mv * dh_tot;
        dc_c = mv * dc_tot;
        c_cand = rv[1] * c_prev + rv[0] * rv[3];
      }
      const CellGrad d = cell_bwd(rv[0], rv[1], rv[2], rv[3], c_cand, c_prev, dh_c, dc_c,
                                  peeps ? &pv[0] : nullptr, peeps ? &pv[1] : nullptr,
                                  peeps ? &pv[2] : nullptr, 0);
      float* zr = dz + ((size_t)t * B + r) * K + hu;
      zr[0] = d.dzi;
      zr[H] = d.dzf;
      zr[2 * H] = d.dzo;
      zr[3 * H] = d.dzg;
      __nv_bfloat16* xr = dzx + (size_t)(t & 1) * BK + (size_t)r * K + hu;
      store_w(xr, d.dzi);
      store_w(xr + H, d.dzf);
      store_w(xr + 2 * H, d.dzo);
      store_w(xr + 3 * H, d.dzg);
      if (peeps) {
        dp[0] += d.dzi * c_prev;
        dp[1] += d.dzf * c_prev;
        dp[2] += d.dzo * c_cand;
      }
      resid = (1.0f - mv) * dh_tot;
      dc = d.dc_prev + (1.0f - mv) * dc_tot;
    }
    prefetch(t - 1);  // lands during the barrier and the products
  }
  // dh before step 0 = bf16(dz_0) . RW^T + the residual (dz_0 is in slot 0)
  grid.sync();
  dh = product(0) + resid;
  cp_async_wait<0>();
  if (cell_on) {
    dh0[at] = dh;
    dc0[at] = dc;
  }
  if (peeps) {
    __syncthreads();  // every cell thread has read the tiles
    float* dp_s = reinterpret_cast<float*>(rings);  // [B * HB][3]
    if (cell_on)
      for (int k = 0; k < 3; ++k) dp_s[tid * 3 + k] = dp[k];
    __syncthreads();
    for (int qi = tid; qi < 3 * HB; qi += blockDim.x) {
      const int k = qi / HB, uu = qi % HB;
      float sum = 0.0f;
      for (int rr = 0; rr < B; ++rr) sum += dp_s[(rr * HB + uu) * 3 + k];
      dpeep[(size_t)k * H + u0 + uu] = sum;
    }
  }
}

// Whether the tensor-core body takes this shape on the current device (and
// the kernel's shared-memory limit set for it): every block of the grid
// must be resident at once for the grid barrier.
bool bwd_tc_fits(int B, int H) {
  if (H % kBwdUnits || B < 1 || B > kBwdMaxB) return false;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = bwd_tc_smem(H);
  if (smem > (size_t)max_smem) return false;
  if (cudaFuncSetAttribute(lstm_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return false;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_bwd_tc_kernel, kThreads,
                                                    smem) != cudaSuccess)
    return false;
  return (long)per_sm * sms >= H / kBwdUnits;
}

int launch_bwd_tc(const void* dy, const void* gates, const void* cseq, const void* rw,
                  const void* peep, const void* mask, const void* c0, const void* dhT,
                  const void* dcT, void* dzx, void* dz, void* dh0, void* dc0, void* dpeep, int T,
                  int B, int H, cudaStream_t stream) {
  const float* dy_ = static_cast<const float*>(dy);
  const float* gates_ = static_cast<const float*>(gates);
  const float* cseq_ = static_cast<const float*>(cseq);
  const __nv_bfloat16* rw_ = static_cast<const __nv_bfloat16*>(rw);
  const float* peep_ = static_cast<const float*>(peep);
  const float* mask_ = static_cast<const float*>(mask);
  const float* c0_ = static_cast<const float*>(c0);
  const float* dhT_ = static_cast<const float*>(dhT);
  const float* dcT_ = static_cast<const float*>(dcT);
  __nv_bfloat16* dzx_ = static_cast<__nv_bfloat16*>(dzx);
  float* dz_ = static_cast<float*>(dz);
  float* dh0_ = static_cast<float*>(dh0);
  float* dc0_ = static_cast<float*>(dc0);
  float* dpeep_ = static_cast<float*>(dpeep);
  void* args[] = {&dy_, &gates_, &cseq_, &rw_, &peep_, &mask_, &c0_, &dhT_, &dcT_,
                  &dzx_, &dz_, &dh0_, &dc0_, &dpeep_, &T, &B, &H};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_tc_kernel,
                                                dim3(H / kBwdUnits), dim3(kThreads), args,
                                                bwd_tc_smem(H), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dl4j

// Plain C entry bound with ctypes. rw_bf16 selects the type of rw and of
// the dz exchange buffer dzx [2, B, 4H] (bf16 or f32); every other tensor
// is f32 and contiguous; peep/dpeep are both set or both null, mask may be
// null. bf16 weights at a shape the tensor-core body takes launch it
// (dl4j_lstm_bwd_tc), everything else the CUDA-core body. Returns a
// cudaError_t (0 on success).
extern "C" int dl4j_lstm_bwd(const void* dy, const void* gates, const void* cseq, const void* rw,
                             int rw_bf16, const void* peep, const void* mask, const void* c0,
                             const void* dhT, const void* dcT, void* dzx, void* dz, void* dh0,
                             void* dc0, void* dpeep, int T, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rw_bf16 && dl4j::bwd_tc_fits(B, H))
    return dl4j::launch_bwd_tc(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT, dzx, dz, dh0, dc0,
                               dpeep, T, B, H, s);
  if (rw_bf16)
    return dl4j::launch_bwd<__nv_bfloat16>(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT, dzx,
                                           dz, dh0, dc0, dpeep, T, B, H, s);
  return dl4j::launch_bwd<float>(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT, dzx, dz, dh0,
                                 dc0, dpeep, T, B, H, s);
}

// 1 when dl4j_lstm_bwd takes the tensor-core body for these weights and
// this shape on the current device, 0 when the CUDA-core body.
extern "C" int dl4j_lstm_bwd_tc(int w_bf16, int B, int H) {
  return w_bf16 && dl4j::bwd_tc_fits(B, H) ? 1 : 0;
}

// Hidden units a block of the body dl4j_lstm_bwd launches for these
// weights and this shape on the current device (the grid has H / units
// blocks; 0 when no grid fits).
extern "C" int dl4j_lstm_bwd_units(int w_bf16, int B, int H) {
  size_t smem = 0;
  if (w_bf16 && dl4j::bwd_tc_fits(B, H)) return dl4j::kBwdUnits;
  return w_bf16 ? dl4j::bwd_units<__nv_bfloat16>(B, H, &smem) : dl4j::bwd_units<float>(B, H, &smem);
}
