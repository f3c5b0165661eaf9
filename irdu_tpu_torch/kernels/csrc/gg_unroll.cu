// K1: the whole two-scale GGTV+GGLR ADMM/CG unroll of one flagship filtering
// block, CHW. Replaces irdu_tpu/ops/pallas/solver_unroll.py:gg_unroll_chw
// (_unroll_kernel; plane helpers in solver_chw.py). The math, the reference
// quirks and the bound are set out in irdu_tpu_torch/ops/solver_unroll.py.
//
// One CTA per (b, g, f) plane, the TPU grid's parallelism. The CTA walks its
// plane once per stage and keeps every stage plane in f32 global scratch
// (8 full-res + 5 half-res planes per CTA, allocated by the wrapper);
// __syncthreads() orders one stage's writes before the next stage's
// neighbour reads. Because each derived plane is materialized whole, a
// clamped read replicates that plane's own edge row, as the reference does.
// Scratch is read through plain pointers (never const __restrict__) so the
// compiler does not route it through the non-coherent read-only cache.
//
// Known limit, left to the redesign PR: at 512^2 scale 0 the grid is only
// 48 CTAs on 132 SMs, and the stage planes (8 MiB per CTA there) spill out
// of L2. Splitting each plane over several CTAs with a halo, or a cluster
// sharing the plane through distributed shared memory, fixes both.

#include "common.cuh"

namespace irdu {

constexpr int kThreads = 512;  // 128 registers a thread: the stage state stays unspilled

// Polynomial 3x3 stencil, replicate boundary (ops.graph.stats_conv).
__device__ __forceinline__ float stats_at(const float* s, const Stats& c, int i,
                                          int j, int H, int W) {
  const float v = s[i * W + j];
  const float r = s[i * W + min(j + 1, W - 1)];
  const float d = s[min(i + 1, H - 1) * W + j];
  const float u = s[max(i - 1, 0) * W + j];
  const float l = s[i * W + max(j - 1, 0)];
  return c.p[0] * v + c.p[1] * (r - v) + c.p[2] * (d - v) +
         c.p[3] * (4.f * v - u - d - l - r);
}

// Its reference adjoint: flipped taps, zero boundary (stats_conv_transpose).
__device__ __forceinline__ float stats_t_at(const float* s, const Stats& c, int i,
                                            int j, int H, int W) {
  const float v = s[i * W + j];
  const float r0 = j + 1 < W ? s[i * W + j + 1] : 0.f;
  const float d0 = i + 1 < H ? s[(i + 1) * W + j] : 0.f;
  const float u0 = i > 0 ? s[(i - 1) * W + j] : 0.f;
  const float l0 = j > 0 ? s[i * W + j - 1] : 0.f;
  return c.p[0] * v + c.p[1] * (l0 - v) + c.p[2] * (u0 - v) +
         c.p[3] * (4.f * v - u0 - d0 - l0 - r0);
}

// sum_e [wei_e(p) - wei_e(p - d_e)], wei_e(q) = w_e(q) * map(w_e(q) * (s(q) -
// s(clamp(q + d_e)))), the zero-padded scatter of C^T before its stencil.
template <bool kRethresh, typename T>
__device__ __forceinline__ float gtv_edge_sum(const float* s, const T* w, int n,
                                              int i, int j, int H, int W,
                                              float gamma) {
  const float sp = s[i * W + j];
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int dh = dh_of(e), dw = dw_of(e);
    const T* we = w + (size_t)e * n;
    const int ii = min(max(i + dh, 0), H - 1);
    const int jj = min(max(j + dw, 0), W - 1);
    const float wp = ld(we[i * W + j]);
    const float own = wp * edge_map<kRethresh>(wp * (sp - s[ii * W + jj]), gamma);
    const int qi = i - dh, qj = j - dw;
    float nbr = 0.f;
    if (qi >= 0 && qi < H && qj >= 0 && qj < W) {
      const float wq = ld(we[qi * W + qj]);
      nbr = wq * edge_map<kRethresh>(wq * (s[qi * W + qj] - sp), gamma);
    }
    const float term = own - nbr;
    acc = e == 0 ? term : acc + term;
  }
  return acc;
}

// s(p) - sum_e w_e(p) s(clamp(p + d_e)), the random-walk Laplacian of GLR.
template <typename T>
__device__ __forceinline__ float glr_lap(const float* s, const T* w, int n, int i,
                                         int j, int H, int W) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ii = min(max(i + dh_of(e), 0), H - 1);
    const int jj = min(max(j + dw_of(e), 0), W - 1);
    const float term = ld(w[(size_t)e * n + i * W + j]) * s[ii * W + jj];
    acc = e == 0 ? term : acc + term;
  }
  return s[i * W + j] - acc;
}

template <typename T>
__device__ __forceinline__ float box_down_at(const T* x, int i2, int j2, int W) {
  const int a = 2 * i2 * W + 2 * j2;
  return 0.25f * (ld(x[a]) + ld(x[a + 1]) + ld(x[a + W]) + ld(x[a + W + 1]));
}

template <typename T>
struct Plane {  // one CTA's view of its (b, g, f) problem
  int H, W, H2, W2, n0, n1;
  const T *wgtv0, *wglr0, *wgtv1, *wglr1;  // (4, H, W) / (4, H/2, W/2)
  Stats sg0, sl0, sg1, sl1;                // GTV/GLR stencils at both scales
  float mu0, ro0, mu1, ro1, gam0, gam1;
  float *Y, *X, *R, *U, *P0, *P1, *P2, *P3;  // full-res scratch planes
  float *Xd, *Q0, *Q1, *Q2, *Q3;             // half-res scratch planes
};

#define FOR_PIXELS(n) for (int p = threadIdx.x; p < (n); p += blockDim.x)

// dst = Y + ro0 C0^T map(C0 src) + Up(ro1 C1^T map(C1 srcd)), map as edge_map:
// the ADMM init RHS (identity) and the re-threshold RHS.
template <bool kRethresh, typename T>
__device__ void gtv_rhs(const Plane<T>& P, const float* src, const float* srcd,
                        float* dst) {
  const int H = P.H, W = P.W, H2 = P.H2, W2 = P.W2;
  FOR_PIXELS(P.n0) { const int i = p / W, j = p - i * W; P.P0[p] = stats_at(src, P.sg0, i, j, H, W); }
  FOR_PIXELS(P.n1) { const int i = p / W2, j = p - i * W2; P.Q0[p] = stats_at(srcd, P.sg1, i, j, H2, W2); }
  __syncthreads();
  FOR_PIXELS(P.n0) {
    const int i = p / W, j = p - i * W;
    P.P1[p] = gtv_edge_sum<kRethresh>(P.P0, P.wgtv0, P.n0, i, j, H, W, P.gam0);
  }
  FOR_PIXELS(P.n1) {
    const int i = p / W2, j = p - i * W2;
    P.Q1[p] = gtv_edge_sum<kRethresh>(P.Q0, P.wgtv1, P.n1, i, j, H2, W2, P.gam1);
  }
  __syncthreads();
  FOR_PIXELS(P.n1) { const int i = p / W2, j = p - i * W2; P.Q2[p] = P.ro1 * stats_t_at(P.Q1, P.sg1, i, j, H2, W2); }
  __syncthreads();
  FOR_PIXELS(P.n0) {
    const int i = p / W, j = p - i * W;
    dst[p] = P.Y[p] + P.ro0 * stats_t_at(P.P1, P.sg0, i, j, H, W) +
             0.25f * P.Q2[(i >> 1) * W2 + (j >> 1)];
  }
  __syncthreads();
}

__device__ __forceinline__ void box_down_stage(const float* x, float* xd, int n1, int W, int W2) {
  FOR_PIXELS(n1) { const int i = p / W2, j = p - i * W2; xd[p] = box_down_at(x, i, j, W); }
  __syncthreads();
}

// One CG step on X: A.X = X + mu0 GLR0 X + ro0 Q0 X + Up(mu1 GLR1 + ro1 Q1) Dn X,
// then step 0: X += a (X - A.X); step 1: U = R - A.X, X += a U;
// step 2: U' = R - A.X + beta2 U, X += a U'. The last step writes `out`.
template <typename T>
__device__ void cg_step(const Plane<T>& P, int step, float alpha, float beta2,
                        T* out) {
  const int H = P.H, W = P.W, H2 = P.H2, W2 = P.W2;
  box_down_stage(P.X, P.Xd, P.n1, W, W2);
  FOR_PIXELS(P.n0) {
    const int i = p / W, j = p - i * W;
    P.P0[p] = stats_at(P.X, P.sg0, i, j, H, W);
    P.P1[p] = stats_at(P.X, P.sl0, i, j, H, W);
  }
  FOR_PIXELS(P.n1) {
    const int i = p / W2, j = p - i * W2;
    P.Q0[p] = stats_at(P.Xd, P.sg1, i, j, H2, W2);
    P.Q1[p] = stats_at(P.Xd, P.sl1, i, j, H2, W2);
  }
  __syncthreads();
  FOR_PIXELS(P.n0) {
    const int i = p / W, j = p - i * W;
    P.P2[p] = gtv_edge_sum<false>(P.P0, P.wgtv0, P.n0, i, j, H, W, 0.f);
    P.P3[p] = glr_lap(P.P1, P.wglr0, P.n0, i, j, H, W);
  }
  FOR_PIXELS(P.n1) {
    const int i = p / W2, j = p - i * W2;
    P.Q2[p] = gtv_edge_sum<false>(P.Q0, P.wgtv1, P.n1, i, j, H2, W2, 0.f);
    P.Q3[p] = glr_lap(P.Q1, P.wglr1, P.n1, i, j, H2, W2);
  }
  __syncthreads();
  FOR_PIXELS(P.n1) {
    const int i = p / W2, j = p - i * W2;
    P.Q0[p] = P.ro1 * stats_t_at(P.Q2, P.sg1, i, j, H2, W2) +
              P.mu1 * stats_t_at(P.Q3, P.sl1, i, j, H2, W2);
  }
  __syncthreads();
  FOR_PIXELS(P.n0) {
    const int i = p / W, j = p - i * W;
    const float t0 = P.ro0 * stats_t_at(P.P2, P.sg0, i, j, H, W) +
                     P.mu0 * stats_t_at(P.P3, P.sl0, i, j, H, W);
    const float x = P.X[p];
    const float ax = x + t0 + 0.25f * P.Q0[(i >> 1) * W2 + (j >> 1)];
    float xn;
    if (step == 0) {
      xn = x + alpha * (x - ax);
    } else {
      const float u = step == 1 ? P.R[p] - ax : P.R[p] - ax + beta2 * P.U[p];
      P.U[p] = u;
      xn = x + alpha * u;
    }
    if (out != nullptr) st(out + p, xn); else P.X[p] = xn;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gg_unroll_kernel(const T* __restrict__ y, const T* __restrict__ wgtv0,
                 const T* __restrict__ wglr0, const T* __restrict__ wgtv1,
                 const T* __restrict__ wglr1, const float* __restrict__ pgtv0,
                 const float* __restrict__ pglr0, const float* __restrict__ pgtv1,
                 const float* __restrict__ pglr1, const float* __restrict__ scal,
                 T* __restrict__ out, float* scratch, int G, int F, int H, int W,
                 int iters) {
  const int plane = blockIdx.x;  // (b * G + g) * F + f = channel plane of y
  const int f = plane % F;
  const int bg = plane / F;
  const int g = bg % G;
  Plane<T> P;
  P.H = H; P.W = W; P.H2 = H / 2; P.W2 = W / 2;
  P.n0 = H * W; P.n1 = P.H2 * P.W2;
  P.wgtv0 = wgtv0 + (size_t)bg * 4 * P.n0;
  P.wglr0 = wglr0 + (size_t)bg * 4 * P.n0;
  P.wgtv1 = wgtv1 + (size_t)bg * 4 * P.n1;
  P.wglr1 = wglr1 + (size_t)bg * 4 * P.n1;
  P.sg0 = load_stats(pgtv0, g, F, f);
  P.sl0 = load_stats(pglr0, g, F, f);
  P.sg1 = load_stats(pgtv1, g, F, f);
  P.sl1 = load_stats(pglr1, g, F, f);
  const float* sc = scal + g * 10;  // [mu0, ro0, mu1, ro1, gam0, gam1, a0, a1, a2, b2]
  P.mu0 = sc[0]; P.ro0 = sc[1]; P.mu1 = sc[2]; P.ro1 = sc[3];
  P.gam0 = sc[4]; P.gam1 = sc[5];
  float* s = scratch + (size_t)plane * (8 * (size_t)P.n0 + 5 * (size_t)P.n1);
  P.Y = s;          P.X = P.Y + P.n0;   P.R = P.X + P.n0;   P.U = P.R + P.n0;
  P.P0 = P.U + P.n0; P.P1 = P.P0 + P.n0; P.P2 = P.P1 + P.n0; P.P3 = P.P2 + P.n0;
  P.Xd = P.P3 + P.n0; P.Q0 = P.Xd + P.n1; P.Q1 = P.Q0 + P.n1; P.Q2 = P.Q1 + P.n1;
  P.Q3 = P.Q2 + P.n1;
  const T* yp = y + (size_t)plane * P.n0;
  T* op = out + (size_t)plane * P.n0;

  FOR_PIXELS(P.n0) P.Y[p] = ld(yp[p]);
  FOR_PIXELS(P.n1) { const int i = p / P.W2, j = p - i * P.W2; P.Xd[p] = box_down_at(yp, i, j, W); }
  __syncthreads();
  gtv_rhs<false>(P, P.Y, P.Xd, P.X);                       // X = rhs_a
  cg_step(P, 0, sc[6], 0.f, iters == 1 ? op : nullptr);    // CG step 1
  if (iters == 1) return;
  box_down_stage(P.X, P.Xd, P.n1, W, P.W2);
  gtv_rhs<true>(P, P.X, P.Xd, P.R);                        // R = rhs_b
  cg_step(P, 1, sc[7], 0.f, iters == 2 ? op : nullptr);    // CG step 2
  if (iters == 2) return;
  cg_step(P, 2, sc[8], sc[9], op);                         // CG step 3
}

}  // namespace irdu

extern "C" long long irdu_gg_unroll_scratch_floats(int H, int W) {
  return 8LL * H * W + 5LL * (H / 2) * (W / 2);
}

extern "C" int irdu_gg_unroll(const void* y, const void* wgtv0, const void* wglr0,
                              const void* wgtv1, const void* wglr1,
                              const void* pgtv0, const void* pglr0,
                              const void* pgtv1, const void* pglr1,
                              const void* scal, void* out, void* scratch, int B,
                              int G, int F, int H, int W, int iters, int dtype,
                              void* stream) {
  const dim3 grid(B * G * F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tabs[5] = {static_cast<const float*>(pgtv0), static_cast<const float*>(pglr0),
                          static_cast<const float*>(pgtv1), static_cast<const float*>(pglr1),
                          static_cast<const float*>(scal)};
  float* scr = static_cast<float*>(scratch);
  if (dtype == irdu::kFloat32) {
    using T = float;
    irdu::gg_unroll_kernel<T><<<grid, irdu::kThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const T*>(wgtv0), static_cast<const T*>(wglr0),
        static_cast<const T*>(wgtv1), static_cast<const T*>(wglr1), tabs[0], tabs[1],
        tabs[2], tabs[3], tabs[4], static_cast<T*>(out), scr, G, F, H, W, iters);
  } else if (dtype == irdu::kBFloat16) {
    using T = __nv_bfloat16;
    irdu::gg_unroll_kernel<T><<<grid, irdu::kThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const T*>(wgtv0), static_cast<const T*>(wglr0),
        static_cast<const T*>(wgtv1), static_cast<const T*>(wglr1), tabs[0], tabs[1],
        tabs[2], tabs[3], tabs[4], static_cast<T*>(out), scr, G, F, H, W, iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
