// K2: softmax edge weights of the latent graphs over a window of E offsets,
// CHW. Replaces irdu_tpu/ops/pallas/solver_chw.py:edge_weights_chw
// (_edgew_kernel). Design and bound: see irdu_tpu_torch/ops/edge_weights.py.
//
// One thread per (batch, graph, pixel). With c the centre's F features, n the
// neighbour's and m the metric diagonal, the similarity of the normalized,
// metric-scaled features is  sum_f c_f n_f m_f^2 / (max(|c|,eps) max(|n|,eps)),
// so one pass over the (E + 1) x F reads gives the norms and the dots
// together. The window's offsets come in by value (kernel parameter space),
// and E is a template parameter, so the loops unroll and every offset is a
// constant index.

#include "common.cuh"

namespace irdu {

template <typename T, int E>
__global__ void edge_weights_kernel(const T* __restrict__ feats,
                                    const float* __restrict__ multi_m,
                                    T* __restrict__ out, Window win, int G, int F,
                                    int H, int W) {
  const int hw = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int bg = blockIdx.y;  // b * G + g
  const int g = bg % G;
  const int i = p / W;
  const int j = p - i * W;
  int nb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int ii = min(max(i + win.dh[e], 0), H - 1);
    const int jj = min(max(j + win.dw[e], 0), W - 1);
    nb[e] = ii * W + jj;
  }
  const T* base = feats + (size_t)bg * F * hw;  // channel g*F + f of batch b
  float cc = 0.f;
  float nn[E], dot[E];
#pragma unroll
  for (int e = 0; e < E; ++e) nn[e] = dot[e] = 0.f;
  for (int f = 0; f < F; ++f) {
    const T* plane = base + (size_t)f * hw;
    const float m = multi_m[g * F + f];
    const float c = ld(plane[p]);
    const float cm = c * m * m;
    cc += c * c;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = ld(plane[nb[e]]);
      nn[e] += v * v;
      dot[e] += cm * v;
    }
  }
  const float inv_c = 1.f / fmaxf(sqrtf(cc), 1e-12f);
  float sim[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sim[e] = dot[e] * inv_c / fmaxf(sqrtf(nn[e]), 1e-12f);
  float mx = sim[0];
#pragma unroll
  for (int e = 1; e < E; ++e) mx = fmaxf(mx, sim[e]);
  float den = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sim[e] = expf(sim[e] - mx);
    den += sim[e];
  }
  T* o = out + (size_t)bg * E * hw + p;
#pragma unroll
  for (int e = 0; e < E; ++e) st(o + (size_t)e * hw, sim[e] / den);
}

namespace ew {

template <typename T, int E>
int launch(const void* feats, const float* m, void* out, const Window& win, int B, int G,
           int F, int H, int W, cudaStream_t s) {
  const int threads = 256;
  const dim3 grid((H * W + threads - 1) / threads, B * G);
  edge_weights_kernel<T, E><<<grid, threads, 0, s>>>(
      static_cast<const T*>(feats), m, static_cast<T*>(out), win, G, F, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* feats, const float* m, void* out, const Window& win, int B, int G,
             int F, int H, int W, cudaStream_t s) {
  switch (win.n) {
    case 4: return launch<T, 4>(feats, m, out, win, B, G, F, H, W, s);
    case 12: return launch<T, 12>(feats, m, out, win, B, G, F, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ew
}  // namespace irdu

// deltas: n_edges (dh, dw) pairs in host memory, copied into the launch.
extern "C" int irdu_edge_weights(const void* feats, const void* multi_m, void* out, int B,
                                 int G, int F, int H, int W, const int* deltas, int n_edges,
                                 int dtype, void* stream) {
  irdu::Window win;
  if (!irdu::make_window(deltas, n_edges, &win)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(multi_m);
  if (dtype == irdu::kFloat32)
    return irdu::ew::dispatch<float>(feats, m, out, win, B, G, F, H, W, s);
  if (dtype == irdu::kBFloat16)
    return irdu::ew::dispatch<__nv_bfloat16>(feats, m, out, win, B, G, F, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* irdu_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
