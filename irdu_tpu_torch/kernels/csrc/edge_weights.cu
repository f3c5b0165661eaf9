// K2: softmax cross-4 edge weights of the latent graphs, CHW.
// Replaces irdu_tpu/ops/pallas/solver_chw.py:edge_weights_chw (_edgew_kernel).
// Design and bound: see irdu_tpu_torch/ops/edge_weights.py.
//
// One thread per (batch, graph, pixel). With c the centre's F features, n the
// neighbour's and m the metric diagonal, the similarity of the normalized,
// metric-scaled features is  sum_f c_f n_f m_f^2 / (max(|c|,eps) max(|n|,eps)),
// so one pass over the 5 x F reads gives the norms and the dots together.

#include "common.cuh"

namespace irdu {

template <typename T>
__global__ void edge_weights_kernel(const T* __restrict__ feats,
                                    const float* __restrict__ multi_m,
                                    T* __restrict__ out, int G, int F, int H,
                                    int W) {
  const int hw = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % G;
  const int i = p / W;
  const int j = p - i * W;
  int nb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ii = min(max(i + dh_of(e), 0), H - 1);
    const int jj = min(max(j + dw_of(e), 0), W - 1);
    nb[e] = ii * W + jj;
  }
  const T* base = feats + (size_t)bg * F * hw;  // channel g*F + f of batch b
  float cc = 0.f;
  float nn[4] = {0.f, 0.f, 0.f, 0.f};
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int f = 0; f < F; ++f) {
    const T* plane = base + (size_t)f * hw;
    const float m = multi_m[g * F + f];
    const float c = ld(plane[p]);
    const float cm = c * m * m;
    cc += c * c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = ld(plane[nb[e]]);
      nn[e] += v * v;
      dot[e] += cm * v;
    }
  }
  const float inv_c = 1.f / fmaxf(sqrtf(cc), 1e-12f);
  float sim[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) sim[e] = dot[e] * inv_c / fmaxf(sqrtf(nn[e]), 1e-12f);
  const float mx = fmaxf(fmaxf(sim[0], sim[1]), fmaxf(sim[2], sim[3]));
  float den = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sim[e] = expf(sim[e] - mx);
    den += sim[e];
  }
  T* o = out + (size_t)bg * 4 * hw + p;
#pragma unroll
  for (int e = 0; e < 4; ++e) st(o + (size_t)e * hw, sim[e] / den);
}

}  // namespace irdu

extern "C" int irdu_edge_weights(const void* feats, const void* multi_m,
                                 void* out, int B, int G, int F, int H, int W,
                                 int dtype, void* stream) {
  const int threads = 256;
  const dim3 grid((H * W + threads - 1) / threads, B * G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(multi_m);
  if (dtype == irdu::kFloat32) {
    irdu::edge_weights_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(feats), m, static_cast<float*>(out), G, F, H, W);
  } else if (dtype == irdu::kBFloat16) {
    irdu::edge_weights_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), m,
        static_cast<__nv_bfloat16*>(out), G, F, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* irdu_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
