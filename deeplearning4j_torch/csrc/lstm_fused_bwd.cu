// K4: fused BPTT of two stacked unmasked LSTM layers (the backward of K3).
//
// Replaces the Pallas kernel deeplearning4j_tpu/ops/lstm_fused.py
// `_bwd2_kernel` (wrapper `_bwd2_call`, called by `_lstm2_bwd`).
//
// What it computes, walking t = T-1 .. 0 and carrying (dh1, dc1, dh2, dc2)
// from dhcT, with the unmasked cell gradient of lstm_cell_bwd.cu:
//   layer 2:  dz2[t] = cell_bwd(dy[t] + dh2, dc2; g2[t], c2[t], c2[t-1])
//             dh2 = bf16(dz2[t]) . RW2^T
//   layer 1:  dz1[t] = cell_bwd(dh1 + bf16(dz2[t]) . W2^T, dc1; g1, c1)
//             dh1 = bf16(dz1[t]) . RW1^T
// (c[t-1] is c0 at t = 0), plus both layers' peephole sums, and writes
// dz1, dz2, the state gradients dhc0 and dpeep. dRW1, dW2, dRW2 and db2 are
// products over the whole sequence, formed outside.
//
// What bounds it on an H100: the dependency chain (two cells per step,
// each needing the whole dz of the step after); the three weights (6 MB at
// H=512 bf16) stay resident.
//
// Design: the grid of lstm_cell_bwd.cu with three weight slices per block
// ([HB][4H] rows of RW1, W2, RW2 in shared memory, 48 KB at HB=4 bf16). The
// layers run as a reverse wavefront, as K3 runs forward: phase p computes
// layer 2 at step T-1-p and layer 1 at step T-p. Both need only the dz1 and
// dz2 that phase p-1 published, so one grid.sync() serves both layers and
// each phase makes three products of the exchanged rows: dz2 . RW2^T and
// dz2 . W2^T from one read of dz2, and dz1 . RW1^T. T+1 phases, and one
// more product for dh1 at the start. dz1 and dz2 cross blocks through a
// two-slot buffer each in the weights' type, read through L2 in 8-wide
// chunks, never staged whole in shared memory.
#include "lstm_common.cuh"

namespace dl4j {

// The pick of row_dot's kMaxHB partial sums that belongs to lane s.
__device__ __forceinline__ float lane_pick(const float (&a)[kMaxHB], int s) {
  float v = 0.0f;
#pragma unroll
  for (int u = 0; u < kMaxHB; ++u)
    if (u == s) v = a[u];
  return v;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm2_bwd_kernel(const float* __restrict__ dy,    // [T, B, H] gradient of ys2
                 const float* __restrict__ g1,    // [T, B, 4H] layer-1 gates reserve
                 const float* __restrict__ c1,    // [T, B, H] layer-1 c sequence
                 const float* __restrict__ g2,    // [T, B, 4H]
                 const float* __restrict__ c2,    // [T, B, H]
                 const W* __restrict__ rw1,       // [H, 4H]
                 const W* __restrict__ w2,        // [H, 4H]
                 const W* __restrict__ rw2,       // [H, 4H]
                 const float* __restrict__ peep,  // [6, H] (layer 1 pi,pf,po; layer 2) or null
                 const float* __restrict__ c0,    // [2, B, H] (c1, c2 before step 0)
                 const float* __restrict__ dhcT,  // [4, B, H] (dh1, dc1, dh2, dc2)
                 W* dzx,                          // [2 layers][2 slots][B, 4H] exchange
                 float* __restrict__ dz1,         // [T, B, 4H]
                 float* __restrict__ dz2,         // [T, B, 4H]
                 float* __restrict__ dhc0,        // [4, B, H]
                 float* __restrict__ dpeep,       // [6, H] or null
                 int T, int B, int H, int HB) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * H, E = B * HB;
  const size_t BH = (size_t)B * H, BK = (size_t)B * K;
  W* rw1_s = reinterpret_cast<W*>(smem);  // [HB][4H] each
  W* w2_s = rw1_s + (size_t)HB * K;
  W* rw2_s = w2_s + (size_t)HB * K;
  float* dh1_s = reinterpret_cast<float*>(rw2_s + (size_t)HB * K);  // [B][HB] each
  float* dc1_s = dh1_s + E;
  float* dh2_s = dc1_s + E;
  float* dc2_s = dh2_s + E;
  float* q_s = dc2_s + E;  // dz2 . W2^T: layer 1's input from layer 2
  float* dp_s = q_s + E;   // [B*HB][6] peephole partial sums
  W* x1 = dzx;             // dz1 slots
  W* x2 = dzx + 2 * BK;    // dz2 slots
  const int u0 = blockIdx.x * HB;
  const float* p1 = peep;
  const float* p2 = peep ? peep + 3 * H : nullptr;

  load_unit_rows(rw1_s, rw1, H, HB, u0);
  load_unit_rows(w2_s, w2, H, HB, u0);
  load_unit_rows(rw2_s, rw2, H, HB, u0);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    dh1_s[e] = dhcT[at];
    dc1_s[e] = dhcT[BH + at];
    dh2_s[e] = dhcT[2 * BH + at];
    dc2_s[e] = dhcT[3 * BH + at];
    q_s[e] = 0.0f;
    for (int k = 0; k < 6; ++k) dp_s[6 * e + k] = 0.0f;
  }
  const W* const w_l2[2] = {rw2_s, w2_s};
  const W* const w_l1[1] = {rw1_s};

  for (int p = 0; p <= T; ++p) {
    const bool l2 = p < T, l1 = p >= 1;  // layer 2 at step T-1-p, layer 1 at step T-p
    const int t2 = T - 1 - p, t1 = T - p;
    if (p >= 1) {
      grid.sync();  // phase p-1's dz1 and dz2 are published; also a block barrier
      const W* y2 = x2 + (size_t)((p - 1) & 1) * BK;  // dz2 at step T-p
      const W* y1 = x1 + (size_t)((p - 1) & 1) * BK;  // dz1 at step T-p+1
      const bool has1 = p >= 2;
      for (int it = threadIdx.x; it < dot_items(B); it += blockDim.x) {
        const int r = it / kSplit, s = it % kSplit;
        float a2[2][kMaxHB] = {}, a1[1][kMaxHB] = {};
        if (r < B) {
          row_dot<W, 2>(y2 + (size_t)r * K, w_l2, K, HB, s, a2);
          if (has1) row_dot<W, 1>(y1 + (size_t)r * K, w_l1, K, HB, s, a1);
        }
        lane_reduce<2>(a2);
        if (has1) lane_reduce<1>(a1);
        if (r < B && s < HB) {
          const int e = r * HB + s;
          dh2_s[e] = lane_pick(a2[0], s);
          q_s[e] = lane_pick(a2[1], s);
          if (has1) dh1_s[e] = lane_pick(a1[0], s);
        }
      }
      __syncthreads();
    }
    W* o1 = x1 + (size_t)(p & 1) * BK;
    W* o2 = x2 + (size_t)(p & 1) * BK;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      const int r = e / HB, hu = u0 + e % HB;
      const size_t at = (size_t)r * H + hu;
      if (l2) {
        const float* g = g2 + ((size_t)t2 * B + r) * K;
        const float c_prev = t2 > 0 ? c2[(size_t)(t2 - 1) * BH + at] : c0[BH + at];
        const float c_out = c2[(size_t)t2 * BH + at];
        const CellGrad d = cell_bwd(g[hu], g[H + hu], g[2 * H + hu], g[3 * H + hu], c_out, c_prev,
                                    dy[(size_t)t2 * BH + at] + dh2_s[e], dc2_s[e], p2,
                                    p2 ? p2 + H : nullptr, p2 ? p2 + 2 * H : nullptr, hu);
        float* dzr = dz2 + ((size_t)t2 * B + r) * K;
        W* xr = o2 + (size_t)r * K;
        dzr[hu] = d.dzi;
        dzr[H + hu] = d.dzf;
        dzr[2 * H + hu] = d.dzo;
        dzr[3 * H + hu] = d.dzg;
        store_w(xr + hu, d.dzi);
        store_w(xr + H + hu, d.dzf);
        store_w(xr + 2 * H + hu, d.dzo);
        store_w(xr + 3 * H + hu, d.dzg);
        dc2_s[e] = d.dc_prev;
        if (p2 != nullptr) {
          dp_s[6 * e + 3] += d.dzi * c_prev;
          dp_s[6 * e + 4] += d.dzf * c_prev;
          dp_s[6 * e + 5] += d.dzo * c_out;
        }
      }
      if (l1) {
        const float* g = g1 + ((size_t)t1 * B + r) * K;
        const float c_prev = t1 > 0 ? c1[(size_t)(t1 - 1) * BH + at] : c0[at];
        const float c_out = c1[(size_t)t1 * BH + at];
        const CellGrad d = cell_bwd(g[hu], g[H + hu], g[2 * H + hu], g[3 * H + hu], c_out, c_prev,
                                    dh1_s[e] + q_s[e], dc1_s[e], p1, p1 ? p1 + H : nullptr,
                                    p1 ? p1 + 2 * H : nullptr, hu);
        float* dzr = dz1 + ((size_t)t1 * B + r) * K;
        W* xr = o1 + (size_t)r * K;
        dzr[hu] = d.dzi;
        dzr[H + hu] = d.dzf;
        dzr[2 * H + hu] = d.dzo;
        dzr[3 * H + hu] = d.dzg;
        store_w(xr + hu, d.dzi);
        store_w(xr + H + hu, d.dzf);
        store_w(xr + 2 * H + hu, d.dzo);
        store_w(xr + 3 * H + hu, d.dzg);
        dc1_s[e] = d.dc_prev;
        if (p1 != nullptr) {
          dp_s[6 * e] += d.dzi * c_prev;
          dp_s[6 * e + 1] += d.dzf * c_prev;
          dp_s[6 * e + 2] += d.dzo * c_out;
        }
      }
    }
  }
  // dh1 before step 0 = bf16(dz1_0) . RW1^T (dz1_0 was published in phase T)
  grid.sync();
  const W* y1 = x1 + (size_t)(T & 1) * BK;
  for (int it = threadIdx.x; it < dot_items(B); it += blockDim.x) {
    const int r = it / kSplit, s = it % kSplit;
    float a1[1][kMaxHB] = {};
    if (r < B) row_dot<W, 1>(y1 + (size_t)r * K, w_l1, K, HB, s, a1);
    lane_reduce<1>(a1);
    if (r < B && s < HB) dh1_s[r * HB + s] = lane_pick(a1[0], s);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const size_t at = (size_t)(e / HB) * H + u0 + e % HB;
    dhc0[at] = dh1_s[e];
    dhc0[BH + at] = dc1_s[e];
    dhc0[2 * BH + at] = dh2_s[e];
    dhc0[3 * BH + at] = dc2_s[e];
  }
  if (dpeep != nullptr) {
    for (int q = threadIdx.x; q < 6 * HB; q += blockDim.x) {
      const int k = q / HB, u = q % HB;
      float sum = 0.0f;
      for (int r = 0; r < B; ++r) sum += dp_s[6 * (r * HB + u) + k];
      dpeep[(size_t)k * H + u0 + u] = sum;
    }
  }
}

template <typename W>
int launch2_bwd(const void* dy, const void* g1, const void* c1, const void* g2, const void* c2,
                const void* rw1, const void* w2, const void* rw2, const void* peep,
                const void* c0, const void* dhcT, void* dzx, void* dz1, void* dz2, void* dhc0,
                void* dpeep, int T, int B, int H, cudaStream_t stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  auto kernel = lstm2_bwd_kernel<W>;
  auto smem_for = [&](int hb) {
    if (hb > kMaxHB) return (size_t)-1;  // row_dot keeps kMaxHB sums per thread
    return (size_t)3 * hb * 4 * H * sizeof(W) + (size_t)B * hb * 11 * sizeof(float);
  };
  size_t smem = 0;
  int HB = pick_units_per_block(kernel, H, smem_for, &smem);
  if (HB == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* dy_ = static_cast<const float*>(dy);
  const float* g1_ = static_cast<const float*>(g1);
  const float* c1_ = static_cast<const float*>(c1);
  const float* g2_ = static_cast<const float*>(g2);
  const float* c2_ = static_cast<const float*>(c2);
  const W* rw1_ = static_cast<const W*>(rw1);
  const W* w2_ = static_cast<const W*>(w2);
  const W* rw2_ = static_cast<const W*>(rw2);
  const float* peep_ = static_cast<const float*>(peep);
  const float* c0_ = static_cast<const float*>(c0);
  const float* dhcT_ = static_cast<const float*>(dhcT);
  W* dzx_ = static_cast<W*>(dzx);
  float* dz1_ = static_cast<float*>(dz1);
  float* dz2_ = static_cast<float*>(dz2);
  float* dhc0_ = static_cast<float*>(dhc0);
  float* dpeep_ = static_cast<float*>(dpeep);
  void* args[] = {&dy_, &g1_, &c1_, &g2_, &c2_, &rw1_, &w2_, &rw2_, &peep_, &c0_,
                  &dhcT_, &dzx_, &dz1_, &dz2_, &dhc0_, &dpeep_, &T, &B, &H, &HB};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(H / HB), dim3(kThreads),
                                                args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace dl4j

// Plain C entry bound with ctypes. w_bf16 selects the type of rw1/w2/rw2
// and of the dz exchange buffer dzx [2, 2, B, 4H] (bf16 or f32); every
// other tensor is f32 and contiguous; peep/dpeep are both set or both
// null. Returns a cudaError_t (0 on success).
extern "C" int dl4j_lstm2_bwd(const void* dy, const void* g1, const void* c1, const void* g2,
                              const void* c2, const void* rw1, const void* w2, const void* rw2,
                              int w_bf16, const void* peep, const void* c0, const void* dhcT,
                              void* dzx, void* dz1, void* dz2, void* dhc0, void* dpeep, int T,
                              int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return dl4j::launch2_bwd<__nv_bfloat16>(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT,
                                            dzx, dz1, dz2, dhc0, dpeep, T, B, H, s);
  return dl4j::launch2_bwd<float>(dy, g1, c1, g2, c2, rw1, w2, rw2, peep, c0, dhcT, dzx, dz1,
                                  dz2, dhc0, dpeep, T, B, H, s);
}
