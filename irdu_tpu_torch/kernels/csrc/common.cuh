// Shared helpers for the port's CUDA kernels: element loads/stores in f32 or
// bf16, and the cross-4 window. Compiled with nvcc for sm_90a into one shared
// library with a plain C interface (see ../build.py); no PyTorch headers.
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

}  // namespace irdu
