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
// Design: the cooperative grid of lstm_cell.cu with three weight slices
// per block in shared memory (48 KB at H=512, HB=4, bf16). The two layers
// run as a wavefront: phase p computes layer 1 at step p and layer 2 at
// step p-1. Both need only h1_{p-1} and h2_{p-2}, which the previous phase
// published, so one grid.sync() per phase serves both layers: T+1 phases,
// not 2T. h1 crosses blocks through a two-slot f32 scratch buffer (slot
// p&1 written in phase p, slot (p-1)&1 read), or through ys1 when the
// reserve is written; h2 through ys2.
#include "lstm_common.cuh"

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

template <typename W>
int launch2(const void* xp, const void* rw1, const void* w2, const void* rw2, const void* b2,
            const void* peep, const void* h0, void* hx, void* ys2, void* ys1, void* g1, void* c1,
            void* g2, void* c2, void* hc, int T, int B, int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = ys1 != nullptr ? lstm2_fwd_kernel<W, true> : lstm2_fwd_kernel<W, false>;
  auto smem_for = [&](int hb) {
    return (size_t)B * 10 * hb * sizeof(float) +
           ((size_t)3 * H * 4 * hb + (size_t)2 * B * H) * sizeof(W);
  };
  size_t smem = 0;
  int HB = pick_units_per_block(kernel, H, smem_for, &smem);
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

}  // namespace dl4j

// Plain C entry bound with ctypes. w_bf16 selects the type of rw1/w2/rw2
// (bf16 or f32); every other tensor is f32 and contiguous. Inference
// passes hx and null reserves; training passes ys1, g1, c1, g2, c2 and a
// null hx. Returns a cudaError_t (0 on success).
extern "C" int dl4j_lstm2_fwd(const void* xp, const void* rw1, const void* w2, const void* rw2,
                              int w_bf16, const void* b2, const void* peep, const void* h0,
                              void* hx, void* ys2, void* ys1, void* g1, void* c1, void* g2,
                              void* c2, void* hc, int T, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return dl4j::launch2<__nv_bfloat16>(xp, rw1, w2, rw2, b2, peep, h0, hx, ys2, ys1, g1, c1, g2,
                                        c2, hc, T, B, H, s);
  return dl4j::launch2<float>(xp, rw1, w2, rw2, b2, peep, h0, hx, ys2, ys1, g1, c1, g2, c2, hc, T,
                              B, H, s);
}
