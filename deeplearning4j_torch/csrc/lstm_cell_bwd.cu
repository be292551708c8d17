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
// Design: the cooperative grid of lstm_cell.cu (lstm_common.cuh). Block k
// owns units [k*HB, (k+1)*HB): their dc and dh carries live in shared
// memory, and it computes dz for all four gate columns of them locally.
// The exchanged operand is dz_t [B, 4H], four times the forward's h (256 KB
// at b=64 in bf16, more than a block's shared memory), so it is published
// in RW's type (exact: the reference casts dz to the weight dtype before
// the product) to a two-slot global buffer, and after grid.sync() each
// block reads it through L2 in 8-wide chunks (row_dot) against the block's
// rows of RW, held in shared memory as [HB][4H]. One grid.sync() per step.
// The peephole sums stay with the owning block: no atomics.
#include "lstm_common.cuh"

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

template <typename W>
int launch_bwd(const void* dy, const void* gates, const void* cseq, const void* rw,
               const void* peep, const void* mask, const void* c0, const void* dhT,
               const void* dcT, void* dzx, void* dz, void* dh0, void* dc0, void* dpeep, int T,
               int B, int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = lstm_bwd_kernel<W>;
  auto smem_for = [&](int hb) {
    if (hb > kMaxHB) return (size_t)-1;  // row_dot keeps kMaxHB sums per thread
    return (size_t)hb * 4 * H * sizeof(W) + (size_t)B * hb * 6 * sizeof(float);
  };
  size_t smem = 0;
  int HB = pick_units_per_block(kernel, H, smem_for, &smem);
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

}  // namespace dl4j

// Plain C entry bound with ctypes. rw_bf16 selects the type of rw and of
// the dz exchange buffer dzx [2, B, 4H] (bf16 or f32); every other tensor
// is f32 and contiguous; peep/dpeep are both set or both null, mask may be
// null. Returns a cudaError_t (0 on success).
extern "C" int dl4j_lstm_bwd(const void* dy, const void* gates, const void* cseq, const void* rw,
                             int rw_bf16, const void* peep, const void* mask, const void* c0,
                             const void* dhT, const void* dcT, void* dzx, void* dz, void* dh0,
                             void* dc0, void* dpeep, int T, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rw_bf16)
    return dl4j::launch_bwd<__nv_bfloat16>(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT, dzx,
                                           dz, dh0, dc0, dpeep, T, B, H, s);
  return dl4j::launch_bwd<float>(dy, gates, cseq, rw, peep, mask, c0, dhT, dcT, dzx, dz, dh0,
                                 dc0, dpeep, T, B, H, s);
}
