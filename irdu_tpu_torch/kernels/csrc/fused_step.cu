// K5, K6a and K6b: one unroll step of the GGTV+GGLR solvers (rhs, cg or
// rethresh; two-scale cross-4 for the flagship, single-scale diamond-12 with
// the reflect stencil pad for the pixel family), and its single-scale pieces
// (the system matvec and the ADMM re-threshold), CHW. Replaces
// irdu_tpu/ops/pallas/solver_chw.py:gg_fused_step_chw (_fused_kernel),
// gg_matvec_chw (_matvec_kernel) and gtv_rethresh_chw (_rethresh_kernel).
// The math, the boundary rules and the bound are set out in
// irdu_tpu_torch/ops/fused_step.py.
//
// One CTA per 32x64 full-res output tile of one (b, g, f) plane. Stages,
// separated by __syncthreads(), over the tile's region (the tile plus a
// 4-pixel halo, clipped to the image) and, two-scale, over the half tile's
// region (16x32 plus its own 4 half-res pixels, box-averaged from x):
//   1. X  = x over the region;           XD = Dn x over the half region
//   2. Sg = statsGTV(X), Sl = statsGLR(X) (and at half res)
//   3. Ag = the zero-padded C^T scatter of w * map(w * (Sg - shift Sg)),
//      Al = Sl - sum_e w_e shift_e Sl  (and at half res)
//   4. T1 = rho1 statsGTV^T(Ag1) + mu1 statsGLR^T(Al1) over the half tile
//   5. T  = rho0 statsGTV^T(Ag) + mu0 statsGLR^T(Al) + 0.25 T1 up, then the
//      epilogue: x + T (rhs, matvec), [aux +] T (rethresh, matvec without
//      identity), or the CG update.
// map is the identity for C^T C and 2 S_gamma(e) - e for the re-threshold.
// Every stage plane is f32 in shared memory (<= 76.8 KB a CTA).
//
// Reads of a derived plane are clamped to the region: at an image edge that
// replicates the plane's own edge, as the reference's shifts do; past an
// interior edge it is a halo value that is wrong, and the error moves inward
// by 1 (stencil) + the window's radius r <= 2 (edge sums) + 1 (stencil^T)
// <= 4 pixels, so it never reaches the tile. The stencil's own input x pads
// by replication ("edge") or by reflection without the edge ("reflect", the
// pixel family): a read past the image edge mirrors to the pixel on the other
// side. The C^T scatter and the transposed stencil read zeros outside the
// image, tested against global indices. The window (cross-4 or diamond-12)
// is a template parameter; diamond-12 runs single-scale only.

#include "common.cuh"

namespace irdu {
namespace step {

constexpr int kTH = 32, kTW = 64;  // full-res tile; even, so half tiles are whole boxes
constexpr int kHalo = 4;           // stats 1, the edge sum's shifts r <= 2, stats^T 1
constexpr int kThreads = 256;
constexpr int kR0 = (kTH + 2 * kHalo) * (kTW + 2 * kHalo);          // full-res region
constexpr int kR1 = (kTH / 2 + 2 * kHalo) * (kTW / 2 + 2 * kHalo);  // half-res region
constexpr int kEpiAddX = 0, kEpiAddAux = 1, kEpiCg = 2;  // as in ops/fused_step.py

// Rows [r0, r0 + rh) and columns [c0, c0 + rw) of an H x W plane; the
// region lies inside the image.
struct Region {
  int r0, c0, rh, rw, H, W;
  // the local index of (i, j) clamped to the region
  __device__ __forceinline__ int at(int i, int j) const {
    return (min(max(i, r0), r0 + rh - 1) - r0) * rw + min(max(j, c0), c0 + rw - 1) - c0;
  }
  __device__ __forceinline__ bool in_image(int i, int j) const {
    return i >= 0 && i < H && j >= 0 && j < W;
  }
};

__device__ __forceinline__ Region region(int i0, int i1, int j0, int j1, int H, int W) {
  Region R;
  R.H = H;
  R.W = W;
  R.r0 = max(i0 - kHalo, 0);
  R.c0 = max(j0 - kHalo, 0);
  R.rh = min(i1 + kHalo, H) - R.r0;
  R.rw = min(j1 + kHalo, W) - R.c0;
  return R;
}

// The window's offsets: cross-4 (kWin 0) or diamond-12 (kWin 1).
template <int kWin>
struct Win {
  static constexpr int E = kWin == 0 ? 4 : kDiamondEdges;
  __device__ __forceinline__ static int dh(int e) { return kWin == 0 ? dh_of(e) : d12_dh(e); }
  __device__ __forceinline__ static int dw(int e) { return kWin == 0 ? dw_of(e) : d12_dw(e); }
};

// Polynomial 3x3 stencil (ops.graph.stats_conv): past the image edge a read
// replicates the edge (the clamp to the region, which ends there) or, with
// reflect, takes the pixel on the other side of it.
__device__ __forceinline__ float stats_at(const float* s, const Region& R, const Stats& c,
                                          int i, int j, bool reflect) {
  const int jr = j + 1 < R.W ? j + 1 : (reflect ? j - 1 : j);
  const int jl = j > 0 ? j - 1 : (reflect ? j + 1 : j);
  const int id = i + 1 < R.H ? i + 1 : (reflect ? i - 1 : i);
  const int iu = i > 0 ? i - 1 : (reflect ? i + 1 : i);
  const float v = s[R.at(i, j)];
  const float r = s[R.at(i, jr)], d = s[R.at(id, j)];
  const float u = s[R.at(iu, j)], l = s[R.at(i, jl)];
  return c.p[0] * v + c.p[1] * (r - v) + c.p[2] * (d - v) + c.p[3] * (4.f * v - u - d - l - r);
}

// Its reference adjoint: flipped taps, zero outside the image.
__device__ __forceinline__ float stats_t_at(const float* s, const Region& R, const Stats& c,
                                            int i, int j) {
  const float v = s[R.at(i, j)];
  const float r0 = j + 1 < R.W ? s[R.at(i, j + 1)] : 0.f;
  const float d0 = i + 1 < R.H ? s[R.at(i + 1, j)] : 0.f;
  const float u0 = i > 0 ? s[R.at(i - 1, j)] : 0.f;
  const float l0 = j > 0 ? s[R.at(i, j - 1)] : 0.f;
  return c.p[0] * v + c.p[1] * (l0 - v) + c.p[2] * (u0 - v) +
         c.p[3] * (4.f * v - u0 - d0 - l0 - r0);
}

// sum_e [wei_e(p) - wei_e(p - d_e)], wei_e(q) = w_e(q) map(w_e(q) (s(q) -
// s(q + d_e))), the second term zero where p - d_e is outside the image.
// s(p + d_e) past the image edge is s(p) (the replicate pad), which the
// clamp gives since the region ends there.
template <int kWin, bool kRethresh, typename T>
__device__ __forceinline__ float gtv_edge_sum(const float* s, const Region& R, const T* w,
                                              size_t n, int i, int j, float gamma) {
  const float sp = s[R.at(i, j)];
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < Win<kWin>::E; ++e) {
    const int dh = Win<kWin>::dh(e), dw = Win<kWin>::dw(e);
    const T* we = w + e * n;
    const float wp = ld(we[(size_t)i * R.W + j]);
    acc += wp * edge_map<kRethresh>(wp * (sp - s[R.at(i + dh, j + dw)]), gamma);
    const int qi = i - dh, qj = j - dw;
    if (R.in_image(qi, qj)) {
      const float wq = ld(we[(size_t)qi * R.W + qj]);
      acc -= wq * edge_map<kRethresh>(wq * (s[R.at(qi, qj)] - sp), gamma);
    }
  }
  return acc;
}

// s(p) - sum_e w_e(p) s(p + d_e), the random-walk Laplacian of GLR.
template <int kWin, typename T>
__device__ __forceinline__ float glr_lap(const float* s, const Region& R, const T* w, size_t n,
                                         int i, int j) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < Win<kWin>::E; ++e)
    acc += ld(w[e * n + (size_t)i * R.W + j]) *
           s[R.at(i + Win<kWin>::dh(e), j + Win<kWin>::dw(e))];
  return s[R.at(i, j)] - acc;
}

struct Args {
  const void *x, *aux, *prev;
  const void *wg0, *wl0, *wg1, *wl1;  // (B, G, E, H, W) / (B, G, E, H/2, W/2)
  const float *pg0, *pl0, *pg1, *pl1;  // (G, 4, F) stats tables
  const float* scal;                   // (G, 8): mu0, rho0, mu1, rho1, alpha, beta, gamma0, gamma1
  void *out, *upd;
  int G, F, H, W, epi, use_x_rhs, reflect;
};

// fn(p, i, j) for every local index p of the region, (i, j) its global pixel.
template <typename Fn>
__device__ __forceinline__ void for_region(const Region& R, Fn fn) {
  for (int p = threadIdx.x; p < R.rh * R.rw; p += kThreads) {
    const int li = p / R.rw;
    fn(p, R.r0 + li, R.c0 + p - li * R.rw);
  }
}

// Stage 2 on one scale's region: the stencils.
template <bool kGlr>
__device__ __forceinline__ void stencils(const float* X, float* Sg, float* Sl, const Region& R,
                                         const Stats& sg, const Stats& sl, bool reflect) {
  for_region(R, [&](int p, int i, int j) {
    Sg[p] = stats_at(X, R, sg, i, j, reflect);
    if (kGlr) Sl[p] = stats_at(X, R, sl, i, j, reflect);
  });
}

// Stage 3 on one scale's region: the edge sums.
template <int kWin, bool kRethresh, bool kGlr, typename T>
__device__ __forceinline__ void edge_sums(const float* Sg, const float* Sl, float* Ag, float* Al,
                                          const Region& R, const T* wg, const T* wl, size_t n,
                                          float gamma) {
  for_region(R, [&](int p, int i, int j) {
    Ag[p] = gtv_edge_sum<kWin, kRethresh>(Sg, R, wg, n, i, j, gamma);
    if (kGlr) Al[p] = glr_lap<kWin>(Sl, R, wl, n, i, j);
  });
}

template <typename T, int kWin, bool kRethresh, bool kGlr, bool kTwoScale>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(Args a) {
  constexpr int E = Win<kWin>::E;
  extern __shared__ float smem[];
  const int plane = blockIdx.z;  // (b * G + g) * F + f, a channel plane of x
  const int f = plane % a.F, bg = plane / a.F, g = bg % a.G;
  const int H = a.H, W = a.W, H2 = H / 2, W2 = W / 2;
  const size_t n0 = (size_t)H * W, n1 = (size_t)H2 * W2;
  const int ti0 = blockIdx.y * kTH, tj0 = blockIdx.x * kTW;
  const int ti1 = min(ti0 + kTH, H), tj1 = min(tj0 + kTW, W);
  const Region R0 = region(ti0, ti1, tj0, tj1, H, W);
  const Region R1 = region(ti0 / 2, ti1 / 2, tj0 / 2, tj1 / 2, H2, W2);

  float* s = smem;
  float* X = s;
  float* Sg = X + kR0;
  float* Ag = Sg + kR0;
  float* Sl = Ag + kR0;
  float* Al = Sl + (kGlr ? kR0 : 0);
  float* XD = Al + (kGlr ? kR0 : 0);  // T1 (the half tile's result) once XD is read
  float* Sg1 = XD + kR1;
  float* Ag1 = Sg1 + kR1;
  float* Sl1 = Ag1 + kR1;
  float* Al1 = Sl1 + (kGlr ? kR1 : 0);

  const T* x = static_cast<const T*>(a.x) + plane * n0;
  const T* wg0 = static_cast<const T*>(a.wg0) + bg * E * n0;
  const T* wl0 = kGlr ? static_cast<const T*>(a.wl0) + bg * E * n0 : nullptr;
  const T* wg1 = kTwoScale ? static_cast<const T*>(a.wg1) + bg * E * n1 : nullptr;
  const T* wl1 = kTwoScale && kGlr ? static_cast<const T*>(a.wl1) + bg * E * n1 : nullptr;
  const float* sc = a.scal + g * 8;
  const float mu0 = sc[0], ro0 = sc[1], mu1 = sc[2], ro1 = sc[3];
  const float gam0 = sc[6], gam1 = sc[7];
  const Stats sg0 = load_stats(a.pg0, g, a.F, f);
  const Stats sl0 = kGlr ? load_stats(a.pl0, g, a.F, f) : Stats{};
  const Stats sg1 = kTwoScale ? load_stats(a.pg1, g, a.F, f) : Stats{};
  const Stats sl1 = kTwoScale && kGlr ? load_stats(a.pl1, g, a.F, f) : Stats{};

  // 1. x over the region; its 2x2 box mean over the half region
  for_region(R0, [&](int p, int i, int j) { X[p] = ld(x[(size_t)i * W + j]); });
  if (kTwoScale) {
    for_region(R1, [&](int p, int i, int j) {
      const T* b = x + (size_t)(2 * i) * W + 2 * j;
      XD[p] = 0.25f * (ld(b[0]) + ld(b[1]) + ld(b[W]) + ld(b[W + 1]));
    });
  }
  __syncthreads();
  // 2. the stencils
  const bool reflect = a.reflect != 0;
  stencils<kGlr>(X, Sg, Sl, R0, sg0, sl0, reflect);
  if (kTwoScale) stencils<kGlr>(XD, Sg1, Sl1, R1, sg1, sl1, reflect);
  __syncthreads();
  // 3. the edge sums
  edge_sums<kWin, kRethresh, kGlr>(Sg, Sl, Ag, Al, R0, wg0, wl0, n0, gam0);
  if (kTwoScale) edge_sums<kWin, kRethresh, kGlr>(Sg1, Sl1, Ag1, Al1, R1, wg1, wl1, n1, gam1);
  __syncthreads();
  // 4. the half tile's term, into XD's space
  const int hi0 = ti0 / 2, hj0 = tj0 / 2, tw2 = (tj1 - tj0) / 2;
  float* T1 = XD;
  if (kTwoScale) {
    const int nt = (ti1 - ti0) / 2 * tw2;
    for (int q = threadIdx.x; q < nt; q += kThreads) {
      const int qi = q / tw2, i = hi0 + qi, j = hj0 + q - qi * tw2;
      float t = ro1 * stats_t_at(Ag1, R1, sg1, i, j);
      if (kGlr) t += mu1 * stats_t_at(Al1, R1, sl1, i, j);
      T1[q] = t;
    }
    __syncthreads();
  }
  // 5. the tile: T and the epilogue
  const float alpha = sc[4], beta = sc[5];
  const int tw = tj1 - tj0, nt = (ti1 - ti0) * tw;
  const T* aux = static_cast<const T*>(a.aux);
  const T* prev = static_cast<const T*>(a.prev);
  T* out = static_cast<T*>(a.out);
  T* upd = static_cast<T*>(a.upd);
  for (int q = threadIdx.x; q < nt; q += kThreads) {
    const int qi = q / tw, i = ti0 + qi, j = tj0 + q - qi * tw;
    float t = ro0 * stats_t_at(Ag, R0, sg0, i, j);
    if (kGlr) t += mu0 * stats_t_at(Al, R0, sl0, i, j);
    if (kTwoScale) t += 0.25f * T1[(i / 2 - hi0) * tw2 + (j / 2 - hj0)];
    const float xv = X[R0.at(i, j)];
    const size_t idx = plane * n0 + (size_t)i * W + j;
    float o;
    if (a.epi == kEpiAddX) {
      o = xv + t;
    } else if (a.epi == kEpiAddAux) {
      o = aux != nullptr ? t + ld(aux[idx]) : t;
    } else {  // CG: upd = rhs - A x [+ beta prev], out = x + alpha upd
      const float rhs = a.use_x_rhs ? xv : ld(aux[idx]);
      float u = rhs - (xv + t);
      if (prev != nullptr) u += beta * ld(prev[idx]);
      if (upd != nullptr) st(upd + idx, u);
      o = xv + alpha * u;
    }
    st(out + idx, o);
  }
}

template <typename T, int kWin, bool kRethresh, bool kGlr, bool kTwoScale>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int planes = kGlr ? 5 : 3;  // X (XD), Sg, Ag [, Sl, Al]
  const size_t smem = sizeof(float) * (planes * (size_t)kR0 + (kTwoScale ? planes * kR1 : 0));
  auto kern = fused_step_kernel<T, kWin, kRethresh, kGlr, kTwoScale>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, B * a.G * a.F);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Two-scale on cross-4 (the flagship), single-scale on either window.
template <typename T, int kWin>
int dispatch_win(const Args& a, int B, bool rethresh, bool glr, bool two, cudaStream_t s) {
  constexpr bool kTwo = kWin == 0;  // two-scale instances exist for cross-4 only
  if (two && !kTwo) return static_cast<int>(cudaErrorInvalidValue);
  if (rethresh)
    return two ? launch<T, kWin, true, false, kTwo>(a, B, s) : launch<T, kWin, true, false, false>(a, B, s);
  if (glr)
    return two ? launch<T, kWin, false, true, kTwo>(a, B, s) : launch<T, kWin, false, true, false>(a, B, s);
  return two ? launch<T, kWin, false, false, kTwo>(a, B, s) : launch<T, kWin, false, false, false>(a, B, s);
}

template <typename T>
int dispatch(const Args& a, int B, int win, bool rethresh, bool glr, bool two, cudaStream_t s) {
  return win == 0 ? dispatch_win<T, 0>(a, B, rethresh, glr, two, s)
                  : dispatch_win<T, 1>(a, B, rethresh, glr, two, s);
}

}  // namespace step
}  // namespace irdu

// x, aux, prev, out, upd (B, G*F, H, W) in one dtype; aux, prev, upd may be
// null; wl0/wl1/pl0/pl1 are read only with glr, wg1/wl1/pg1/pl1 only
// two-scale (wg1 non-null). window: 0 cross-4, 1 diamond-12 (single-scale);
// reflect: the stencil's pad (0 replicate, 1 reflect).
extern "C" int irdu_fused_step(const void* x, const void* aux, const void* prev,
                               const void* wg0, const void* wl0, const void* wg1,
                               const void* wl1, const void* pg0, const void* pl0,
                               const void* pg1, const void* pl1, const void* scal, void* out,
                               void* upd, int B, int G, int F, int H, int W, int rethresh,
                               int glr, int epi, int use_x_rhs, int window, int reflect,
                               int dtype, void* stream) {
  using namespace irdu::step;
  const bool two = wg1 != nullptr;
  const bool bad =
      B < 1 || G < 1 || F < 1 || H < 1 || W < 1 || (long long)B * G * F > 65535 ||
      (two && (H % 2 || W % 2)) || (rethresh && glr) || epi < kEpiAddX || epi > kEpiCg ||
      window < 0 || window > 1 || (two && window != 0) || (reflect && (H < 2 || W < 2)) ||
      x == nullptr || out == nullptr || wg0 == nullptr || pg0 == nullptr || scal == nullptr ||
      (two && pg1 == nullptr) ||
      (glr && (wl0 == nullptr || pl0 == nullptr || (two && (wl1 == nullptr || pl1 == nullptr)))) ||
      (epi == kEpiCg && !use_x_rhs && aux == nullptr) || (upd != nullptr && epi != kEpiCg);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, aux, prev, wg0, wl0, wg1, wl1,
               static_cast<const float*>(pg0), static_cast<const float*>(pl0),
               static_cast<const float*>(pg1), static_cast<const float*>(pl1),
               static_cast<const float*>(scal), out, upd, G, F, H, W, epi, use_x_rhs,
               reflect};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == irdu::kFloat32) return dispatch<float>(a, B, window, rethresh, glr, two, s);
  if (dtype == irdu::kBFloat16)
    return dispatch<__nv_bfloat16>(a, B, window, rethresh, glr, two, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
