// Shared pieces of the persistent-LSTM kernels (lstm_cell.cu, lstm_fused.cu).
//
// Both kernels split the hidden units over the blocks of one cooperative
// grid: block k owns units [k*HB, (k+1)*HB) and ALL FOUR gate columns of
// them (i|f|o|g are four contiguous H-blocks of the [H, 4H] weights), so
// the cell update is local to the block and only h_t crosses blocks,
// through global memory (L2-resident at serving sizes) and a grid.sync().
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace dl4j {

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// Copy the block's gate columns of a [H, 4H] weight into shared memory.
// Local column j = gate*HB + unit; rows k are grouped by eight so that one
// 16-byte (bf16) load gives a thread eight consecutive k of its column:
// dst[((k/8)*G + j)*8 + k%8]. H must be a multiple of 8.
template <typename W>
__device__ void load_gate_slice(W* dst, const W* __restrict__ src, int H, int HB, int u0) {
  const int G = 4 * HB;
  for (int idx = threadIdx.x; idx < H * G; idx += blockDim.x) {
    const int k = idx / G, j = idx % G;
    dst[((k / 8) * G + j) * 8 + k % 8] = src[(size_t)k * 4 * H + (j / HB) * H + u0 + (j % HB)];
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// h [B, H] f32 in global memory -> shared memory in the weights' type (the
// gemm operand cast, round to nearest). __ldcg reads through L2 only:
// another block wrote these values, and L1 is not coherent across SMs.
// n is a multiple of 4 and src 16-byte aligned; eight 16-byte loads per
// thread are in flight at once, since each waits on L2 latency.
template <typename W>
__device__ void load_h(W* dst, const float* src, int n) {
  constexpr int U = 8;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int n4 = n / 4;
  for (int base = threadIdx.x; base < n4; base += U * blockDim.x) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n4) v[u] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n4) store4(dst + 4 * i, v[u]);
    }
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(b[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// sum_k h[r, k] * w[k, j] over k < H in order, f32 accumulation; h_row is
// one [H] row, w a slice laid out by load_gate_slice.
template <typename W>
__device__ __forceinline__ float dot_col(const W* h_row, const W* w, int H, int G, int j) {
  float acc = 0.0f;
  for (int k8 = 0; k8 < H / 8; ++k8) {
    float hv[8], wv[8];
    load8(h_row + k8 * 8, hv);
    load8(w + ((size_t)k8 * G + j) * 8, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(hv[i], wv[i], acc);
  }
  return acc;
}

struct CellOut {
  float h, c;
};

// One LSTM cell from pre-activations (Graves peepholes when pi != nullptr):
// zi,zf += c*pi,pf; c_new = f*c + i*g; zo += c_new*po; h = o*tanh(c_new).
__device__ __forceinline__ CellOut cell(float zi, float zf, float zo, float zg, float c,
                                        const float* pi, const float* pf, const float* po,
                                        int hu) {
  if (pi != nullptr) {
    zi = zi + c * pi[hu];
    zf = zf + c * pf[hu];
  }
  const float i = sigm(zi), f = sigm(zf), g = tanhf(zg);
  const float cn = f * c + i * g;
  if (po != nullptr) zo = zo + cn * po[hu];
  const float o = sigm(zo);
  return {o * tanhf(cn), cn};
}

constexpr int kThreads = 512;

// Smallest HB dividing H for which H/HB blocks of `kernel` can all be
// resident at once (a cooperative launch needs that). smem_for(HB) gives
// the dynamic shared memory per block. Returns 0 when nothing fits.
template <typename K, typename F>
int pick_units_per_block(K kernel, int H, F smem_for, size_t* smem_out) {
  int dev = 0, sms = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int hb = 1; hb <= H; ++hb) {
    if (H % hb) continue;
    const size_t smem = smem_for(hb);
    if (smem > (size_t)max_smem) return 0;  // grows with hb: nothing larger fits
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
        cudaSuccess)
      return 0;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
        cudaSuccess)
      return 0;
    if ((long)per_sm * sms >= H / hb) {
      *smem_out = smem;
      return hb;
    }
  }
  return 0;
}

}  // namespace dl4j

extern "C" const char* dl4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
