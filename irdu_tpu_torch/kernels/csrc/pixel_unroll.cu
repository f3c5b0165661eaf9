// K7: the whole pixel-family unroll (2 ADMM rounds x 2 CG steps, one scale,
// diamond-12 window, reflect stats pad), CHW. Replaces
// irdu_tpu/ops/pallas/solver_unroll.py:gg_pixel_unroll_chw
// (_pixel_unroll_kernel). The math, the reference quirks and the bound are
// set out in irdu_tpu_torch/ops/pixel_unroll.py.
//
// K1's structure (gg_unroll.cu): one CTA per (b, g, f) plane. The CTA walks
// its plane once per stage (stencil, edge sums, transposed stencil and
// combine), keeps every stage plane in f32 global scratch (7 planes per CTA,
// allocated by the wrapper) and separates stages with __syncthreads().
// Because each derived plane is materialized whole, a clamped neighbour read
// replicates that plane's own edge row, as the reference does. The
// differences from K1: one scale; 12 offsets up to distance 2; the stencil
// mirrors at the image edge (edge excluded) while neighbour reads clamp and
// the C^T scatter and the transposed stencil read zeros; y is plane f of the
// un-tiled (B, F, H, W) image, read where it is needed.
// Scratch is read through plain pointers (never const __restrict__) so the
// compiler does not route it through the non-coherent read-only cache.
//
// Known limit: at 512^2 the grid is 72 CTAs for 132 SMs, and the stage
// planes (7 MiB per CTA) spill out of L2.

#include "common.cuh"

namespace irdu {
namespace pix {

constexpr int kThreads = 512;

// Polynomial 3x3 stencil with the reflect pad (numpy/torch "reflect": the
// neighbour past an edge is the one on the other side, the edge excluded).
template <typename S>
__device__ __forceinline__ float stats_at(const S* s, const Stats& c, int i, int j, int H,
                                          int W) {
  const int jr = j + 1 < W ? j + 1 : j - 1, jl = j > 0 ? j - 1 : j + 1;
  const int id = i + 1 < H ? i + 1 : i - 1, iu = i > 0 ? i - 1 : i + 1;
  const float v = ld(s[i * W + j]);
  const float r = ld(s[i * W + jr]), l = ld(s[i * W + jl]);
  const float d = ld(s[id * W + j]), u = ld(s[iu * W + j]);
  return c.p[0] * v + c.p[1] * (r - v) + c.p[2] * (d - v) +
         c.p[3] * (4.f * v - u - d - l - r);
}

// Its reference adjoint: flipped taps, zero boundary (stats_conv_transpose).
__device__ __forceinline__ float stats_t_at(const float* s, const Stats& c, int i, int j,
                                            int H, int W) {
  const float v = s[i * W + j];
  const float r0 = j + 1 < W ? s[i * W + j + 1] : 0.f;
  const float d0 = i + 1 < H ? s[(i + 1) * W + j] : 0.f;
  const float u0 = i > 0 ? s[(i - 1) * W + j] : 0.f;
  const float l0 = j > 0 ? s[i * W + j - 1] : 0.f;
  return c.p[0] * v + c.p[1] * (l0 - v) + c.p[2] * (u0 - v) +
         c.p[3] * (4.f * v - u0 - d0 - l0 - r0);
}

// sum_e [wei_e(p) - wei_e(p - d_e)], wei_e(q) = w_e(q) map(w_e(q) (s(q) -
// s(clamp(q + d_e)))), the second term zero where p - d_e is outside the
// image: the zero-padded scatter of C^T before its stencil.
template <bool kRethresh, typename T>
__device__ __forceinline__ float gtv_edge_sum(const float* s, const T* w, int n, int i, int j,
                                              int H, int W, float gamma) {
  const float sp = s[i * W + j];
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kDiamondEdges; ++e) {
    const int dh = d12_dh(e), dw = d12_dw(e);
    const T* we = w + (size_t)e * n;
    const int ii = min(max(i + dh, 0), H - 1), jj = min(max(j + dw, 0), W - 1);
    const float wp = ld(we[i * W + j]);
    acc += wp * edge_map<kRethresh>(wp * (sp - s[ii * W + jj]), gamma);
    const int qi = i - dh, qj = j - dw;
    if (qi >= 0 && qi < H && qj >= 0 && qj < W) {
      const float wq = ld(we[qi * W + qj]);
      acc -= wq * edge_map<kRethresh>(wq * (s[qi * W + qj] - sp), gamma);
    }
  }
  return acc;
}

// s(p) - sum_e w_e(p) s(clamp(p + d_e)), the random-walk Laplacian of GLR.
template <typename T>
__device__ __forceinline__ float glr_lap(const float* s, const T* w, int n, int i, int j, int H,
                                         int W) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kDiamondEdges; ++e) {
    const int ii = min(max(i + d12_dh(e), 0), H - 1);
    const int jj = min(max(j + d12_dw(e), 0), W - 1);
    acc += ld(w[(size_t)e * n + i * W + j]) * s[ii * W + jj];
  }
  return s[i * W + j] - acc;
}

template <typename T>
struct Plane {  // one CTA's view of its (b, g, f) problem
  int H, W, n;
  const T* y;            // plane f of the un-tiled image
  const T *wgtv, *wglr;  // (12, H, W)
  Stats sg, sl;          // GTV / GLR stencils
  float mu, ro, gam;
  float *X, *R, *U, *P0, *P1, *P2, *P3;  // scratch planes
};

#define FOR_PIXELS(n) for (int p = threadIdx.x; p < (n); p += blockDim.x)

// R = X = y + ro C^T map(C src): round 1's RHS (identity map, src = y) and the
// re-threshold's (src = X, read only in the first stage).
template <bool kRethresh, typename T, typename S>
__device__ void gtv_rhs(const Plane<T>& P, const S* src) {
  const int H = P.H, W = P.W;
  FOR_PIXELS(P.n) { const int i = p / W, j = p - i * W; P.P0[p] = stats_at(src, P.sg, i, j, H, W); }
  __syncthreads();
  FOR_PIXELS(P.n) {
    const int i = p / W, j = p - i * W;
    P.P1[p] = gtv_edge_sum<kRethresh>(P.P0, P.wgtv, P.n, i, j, H, W, P.gam);
  }
  __syncthreads();
  FOR_PIXELS(P.n) {
    const int i = p / W, j = p - i * W;
    const float r = ld(P.y[p]) + P.ro * stats_t_at(P.P1, P.sg, i, j, H, W);
    P.R[p] = r;
    P.X[p] = r;
  }
  __syncthreads();
}

// One CG step on X: A.X = X + ro Q X + mu GLR X, U' = R - A.X [+ beta U],
// X += alpha U'. The round's first step (first: X == R) has no momentum; the
// last step of the unroll writes `out`.
template <typename T>
__device__ void cg_step(const Plane<T>& P, float alpha, float beta, bool first, T* out) {
  const int H = P.H, W = P.W;
  FOR_PIXELS(P.n) {
    const int i = p / W, j = p - i * W;
    P.P0[p] = stats_at(P.X, P.sg, i, j, H, W);
    P.P1[p] = stats_at(P.X, P.sl, i, j, H, W);
  }
  __syncthreads();
  FOR_PIXELS(P.n) {
    const int i = p / W, j = p - i * W;
    P.P2[p] = gtv_edge_sum<false>(P.P0, P.wgtv, P.n, i, j, H, W, 0.f);
    P.P3[p] = glr_lap(P.P1, P.wglr, P.n, i, j, H, W);
  }
  __syncthreads();
  FOR_PIXELS(P.n) {
    const int i = p / W, j = p - i * W;
    const float x = P.X[p];
    const float ax = x + P.ro * stats_t_at(P.P2, P.sg, i, j, H, W) +
                     P.mu * stats_t_at(P.P3, P.sl, i, j, H, W);
    float u = P.R[p] - ax;
    if (!first) u += beta * P.U[p];
    P.U[p] = u;
    const float xn = x + alpha * u;
    if (out != nullptr) st(out + p, xn); else P.X[p] = xn;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pixel_unroll_kernel(const T* __restrict__ y, const T* __restrict__ wgtv,
                    const T* __restrict__ wglr, const float* __restrict__ pgtv,
                    const float* __restrict__ pglr, const float* __restrict__ scal,
                    T* __restrict__ out, float* scratch, int G, int F, int H, int W) {
  const int plane = blockIdx.x;  // (b * G + g) * F + f: channel g*F + f of the output
  const int f = plane % F;
  const int bg = plane / F;
  const int g = bg % G, b = bg / G;
  Plane<T> P;
  P.H = H; P.W = W; P.n = H * W;
  P.y = y + ((size_t)b * F + f) * P.n;
  P.wgtv = wgtv + (size_t)bg * kDiamondEdges * P.n;
  P.wglr = wglr + (size_t)bg * kDiamondEdges * P.n;
  P.sg = load_stats(pgtv, g, F, f);
  P.sl = load_stats(pglr, g, F, f);
  const float* sc = scal + g * 9;  // [mu, rho, gamma, a0, a1, a2, a3, b1, b3]
  P.mu = sc[0]; P.ro = sc[1]; P.gam = sc[2];
  float* s = scratch + (size_t)plane * 7 * (size_t)P.n;
  P.X = s;           P.R = P.X + P.n;   P.U = P.R + P.n;   P.P0 = P.U + P.n;
  P.P1 = P.P0 + P.n; P.P2 = P.P1 + P.n; P.P3 = P.P2 + P.n;
  T* op = out + (size_t)plane * P.n;

  gtv_rhs<false>(P, P.y);                      // round 1: rhs = y + rho C^T C y
  cg_step<T>(P, sc[3], 0.f, true, nullptr);
  cg_step<T>(P, sc[4], sc[7], false, nullptr);  // beta[1]; beta[0] unused
  gtv_rhs<true>(P, static_cast<const float*>(P.X));  // rhs = y + rho C^T(2 S(Cx) - Cx)
  cg_step<T>(P, sc[5], 0.f, true, nullptr);     // round 2 restarts from the new rhs
  cg_step<T>(P, sc[6], sc[8], false, op);       // beta[3]; beta[2] unused
}

}  // namespace pix
}  // namespace irdu

extern "C" long long irdu_pixel_unroll_scratch_floats(int H, int W) { return 7LL * H * W; }

// y (B, F, H, W); wgtv, wglr (B, G, 12, H, W); pgtv, pglr (G, 4, F) f32;
// scal (G, 9) f32; out (B, G*F, H, W); scratch B*G*F x 7*H*W f32.
extern "C" int irdu_pixel_unroll(const void* y, const void* wgtv, const void* wglr,
                                 const void* pgtv, const void* pglr, const void* scal,
                                 void* out, void* scratch, int B, int G, int F, int H, int W,
                                 int dtype, void* stream) {
  if (B < 1 || G < 1 || F < 1 || H < 2 || W < 2 || (long long)B * G * F > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * G * F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pg = static_cast<const float*>(pgtv);
  const float* pl = static_cast<const float*>(pglr);
  const float* sc = static_cast<const float*>(scal);
  float* scr = static_cast<float*>(scratch);
  if (dtype == irdu::kFloat32) {
    using T = float;
    irdu::pix::pixel_unroll_kernel<T><<<grid, irdu::pix::kThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const T*>(wgtv), static_cast<const T*>(wglr),
        pg, pl, sc, static_cast<T*>(out), scr, G, F, H, W);
  } else if (dtype == irdu::kBFloat16) {
    using T = __nv_bfloat16;
    irdu::pix::pixel_unroll_kernel<T><<<grid, irdu::pix::kThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const T*>(wgtv), static_cast<const T*>(wglr),
        pg, pl, sc, static_cast<T*>(out), scr, G, F, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
