// Shared helpers for the port's CUDA kernels: element loads/stores in f32 or
// bf16, the stencil coefficients and the re-threshold's edge map, the cross-4,
// diamond-12 and ring-8 windows. Compiled with nvcc
// for sm_90a into one shared library with a plain C interface (see
// ../build.py); no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace irdu {

// dtype codes shared with build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Cross-4 window, edge order (dh, dw) = (-1,0), (0,-1), (0,1), (1,0):
// a shift by (dh, dw) reads x[i+dh, j+dw].
__device__ __forceinline__ int dh_of(int e) { return e == 0 ? -1 : (e == 3 ? 1 : 0); }
__device__ __forceinline__ int dw_of(int e) { return e == 1 ? -1 : (e == 2 ? 1 : 0); }

// Stencil coefficients p01, p02a, p02b, p03 of one (g, f) plane, from a
// (G, 4, F) f32 table.
struct Stats {
  float p[4];
};

__device__ __forceinline__ Stats load_stats(const float* tab, int g, int F, int f) {
  Stats s;
#pragma unroll
  for (int k = 0; k < 4; ++k) s.p[k] = tab[(g * 4 + k) * F + f];
  return s;
}

// The edge-domain map applied to eps = w (s - shift s): the identity for
// C^T C, 2 S_gamma(eps) - eps for the ADMM re-threshold.
template <bool kRethresh>
__device__ __forceinline__ float edge_map(float eps, float gamma) {
  if (!kRethresh) return eps;
  const float thr = (eps < -gamma ? eps + gamma : 0.f) + (eps > gamma ? eps - gamma : 0.f);
  return 2.f * thr - eps;
}

// Diamond-12 window (the pixel family), row-major over the 5x5 mask:
// (-2,0) (-1,-1) (-1,0) (-1,1) (0,-2) (0,-1) (0,1) (0,2) (1,-1) (1,0) (1,1) (2,0).
// Called with a constant e inside unrolled loops, so the tables fold away.
constexpr int kDiamondEdges = 12;
__device__ __forceinline__ int d12_dh(int e) {
  constexpr int t[kDiamondEdges] = {-2, -1, -1, -1, 0, 0, 0, 0, 1, 1, 1, 2};
  return t[e];
}
__device__ __forceinline__ int d12_dw(int e) {
  constexpr int t[kDiamondEdges] = {0, -1, 0, 1, -2, -1, 1, 2, -1, 0, 1, 0};
  return t[e];
}

// Ring-8 window (the full 3x3 ring), row-major over the 3x3 mask:
// (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1).
constexpr int kRingEdges = 8;
__device__ __forceinline__ int r8_dh(int e) { return e < 3 ? -1 : (e < 5 ? 0 : 1); }
__device__ __forceinline__ int r8_dw(int e) {
  constexpr int t[kRingEdges] = {-1, 0, 1, -1, 1, -1, 0, 1};
  return t[e];
}

}  // namespace irdu
