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
// Design: one cooperative grid, H/HB blocks, alive for the whole sequence.
// Each block holds its [H, 4*HB] slice of RW in shared memory (16 KB at
// H=512, HB=4, bf16), owns c for its units in shared memory, and publishes
// its slice of h_t by writing ys[t]; grid.sync() separates the steps and
// ys[t-1] is read back (through L2) as the next step's h. One launch per
// sequence; no weight traffic after the first load.
#include "lstm_common.cuh"

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

template <typename W>
int launch(const void* xp, const void* rw, const void* peep, const void* mask, const void* h0,
           const void* c0, void* ys, void* gates, void* cseq, void* hT, void* cT, int T, int B,
           int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = gates != nullptr ? lstm_fwd_kernel<W, true> : lstm_fwd_kernel<W, false>;
  auto smem_for = [&](int hb) {
    return (size_t)B * 5 * hb * sizeof(float) + ((size_t)H * 4 * hb + (size_t)B * H) * sizeof(W);
  };
  size_t smem = 0;
  int HB = pick_units_per_block(kernel, H, smem_for, &smem);
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

}  // namespace dl4j

// Plain C entry bound with ctypes. rw_bf16 selects the weights' type
// (bf16 or f32); every other tensor is f32 and contiguous; gates and cseq
// are both set (training) or both null (inference). Returns a cudaError_t
// (0 on success).
extern "C" int dl4j_lstm_fwd(const void* xp, const void* rw, int rw_bf16, const void* peep,
                             const void* mask, const void* h0, const void* c0, void* ys,
                             void* gates, void* cseq, void* hT, void* cT, int T, int B, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rw_bf16)
    return dl4j::launch<__nv_bfloat16>(xp, rw, peep, mask, h0, c0, ys, gates, cseq, hT, cT, T, B,
                                       H, s);
  return dl4j::launch<float>(xp, rw, peep, mask, h0, c0, ys, gates, cseq, hT, cT, T, B, H, s);
}
