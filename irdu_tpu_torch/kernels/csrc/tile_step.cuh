// One step of the flagship's two-scale GGTV+GGLR unroll on one output tile
// of one (b, g, f) plane: the device code of K1 (gg_unroll.cuh, a persistent
// CTA walking tiles), on the cross-4, diamond-12 or ring-8 window (Win<> of
// padded_tile.cuh) with the stencil's pad "edge", "zero" or "reflect". The
// math, the boundary rules and the bounds are set out in
// irdu_tpu_torch/ops/solver_unroll.py and ops/fused_step.py. (K5, K6a and
// K6b run on the padded tile of padded_tile.cuh instead: fused_step_hopper.cu.)
//
// A tile is 32x64 full-res pixels. Stages, separated by __syncthreads(), over
// the tile's region (the tile plus a 4-pixel halo, clipped to the image) and
// over the half tile's region (16x32 plus its own 4 half-res pixels,
// box-averaged from x):
//   1. X  = x over the region;           XD = Dn x over the half region
//   2. Sg = statsGTV(X), Sl = statsGLR(X) (and at half res)
//   3. Ag = the zero-padded C^T scatter of w * map(w * (Sg - shift Sg)),
//      Al = Sl - sum_e w_e shift_e Sl  (and at half res)
//   4. T1 = rho1 statsGTV^T(Ag1) + mu1 statsGLR^T(Al1) over the half tile
//   5. T  = rho0 statsGTV^T(Ag) + mu0 statsGLR^T(Al) + 0.25 T1 up, then the
//      epilogue: x + T (rhs), [aux +] T (rethresh), or the CG update.
// map is the identity for C^T C and 2 S_gamma(e) - e for the re-threshold.
// Every stage plane is f32 in shared memory (<= 76.8 KB a tile).
//
// Reads of a derived plane are clamped to the region: at an image edge that
// replicates the plane's own edge, as the reference's shifts do (a shift by
// 2 is two shifts by 1, which the clamp composes); past an interior edge it
// is a halo value that is wrong, and the error moves inward by 1 (stencil) +
// r (the edge sums: the window's radius, 1 on cross-4 and ring-8, 2 on
// diamond-12) + 1 (stencil^T) <= 4 pixels, so it never reaches the tile. The
// stencil's own input x pads by replication, which the same clamp gives, by
// zeros, or by numpy's reflect without the edge pixel (the neighbour on the
// other side, inside the region wherever the image edge is). The C^T
// scatter and the transposed stencil read zeros outside the image, tested
// against global indices.
#pragma once

#include "padded_tile.cuh"

namespace irdu {
namespace step {

constexpr int kTH = 32, kTW = 64;  // full-res tile; even, so half tiles are whole boxes
constexpr int kHalo = 4;           // stats 1, the edge sums' shifts r <= 2, stats^T 1
constexpr int kThreads = 256;
constexpr int kR0 = (kTH + 2 * kHalo) * (kTW + 2 * kHalo);          // full-res region
constexpr int kR1 = (kTH / 2 + 2 * kHalo) * (kTW / 2 + 2 * kHalo);  // half-res region
constexpr int kEpiAddX = 0, kEpiAddAux = 1, kEpiCg = 2;  // as in ops/fused_step.py
constexpr int kPadEdge = 0, kPadZero = 1, kPadReflect = 2;  // ops/solver_unroll.py STATS_PADS

// f32 shared memory of one tile with GLR, the most a step takes: X (XD), Sg,
// Ag, Sl, Al at each scale.
constexpr size_t kTileSmem = sizeof(float) * 5 * ((size_t)kR0 + kR1);

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

// Polynomial 3x3 stencil (ops.graph.stats_conv). Past the image edge a read
// replicates the edge (the clamp to the region, which ends there); with
// kAnyPad the pad is `pad`'s instead: zero, or the mirror pixel (reflect).
template <bool kAnyPad>
__device__ __forceinline__ float stats_at(const float* s, const Region& R, const Stats& c,
                                          int i, int j, int pad) {
  const bool refl = kAnyPad && pad == kPadReflect, zero = kAnyPad && pad == kPadZero;
  const int jr = j + 1 < R.W ? j + 1 : (refl ? j - 1 : j);
  const int jl = j > 0 ? j - 1 : (refl ? j + 1 : j);
  const int id = i + 1 < R.H ? i + 1 : (refl ? i - 1 : i);
  const int iu = i > 0 ? i - 1 : (refl ? i + 1 : i);
  const float v = s[R.at(i, j)];
  float r = s[R.at(i, jr)], d = s[R.at(id, j)];
  float u = s[R.at(iu, j)], l = s[R.at(i, jl)];
  if (zero) {
    r = j + 1 < R.W ? r : 0.f;
    d = i + 1 < R.H ? d : 0.f;
    u = i > 0 ? u : 0.f;
    l = j > 0 ? l : 0.f;
  }
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
__device__ __forceinline__ float gtv_edge_sum(const float* s, const Region& R,
                                              const T* __restrict__ w, size_t n, int i, int j,
                                              float gamma) {
  const float sp = s[R.at(i, j)];
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < ptile::Win<kWin>::E; ++e) {
    const int dh = ptile::Win<kWin>::dh(e), dw = ptile::Win<kWin>::dw(e);
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
__device__ __forceinline__ float glr_lap(const float* s, const Region& R,
                                         const T* __restrict__ w, size_t n, int i, int j) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < ptile::Win<kWin>::E; ++e)
    acc += ld(w[e * n + (size_t)i * R.W + j]) *
           s[R.at(i + ptile::Win<kWin>::dh(e), j + ptile::Win<kWin>::dw(e))];
  return s[R.at(i, j)] - acc;
}

// fn(p, i, j) for every local index p of the region, (i, j) its global pixel.
template <typename Fn>
__device__ __forceinline__ void for_region(const Region& R, Fn fn) {
  for (int p = threadIdx.x; p < R.rh * R.rw; p += kThreads) {
    const int li = p / R.rw;
    fn(p, R.r0 + li, R.c0 + p - li * R.rw);
  }
}

// Stage 2 on one scale's region: the stencils.
template <bool kAnyPad, bool kGlr>
__device__ __forceinline__ void stencils(const float* X, float* Sg, float* Sl, const Region& R,
                                         const Stats& sg, const Stats& sl, int pad) {
  for_region(R, [&](int p, int i, int j) {
    Sg[p] = stats_at<kAnyPad>(X, R, sg, i, j, pad);
    if (kGlr) Sl[p] = stats_at<kAnyPad>(X, R, sl, i, j, pad);
  });
}

// Stage 3 on one scale's region: the edge sums.
template <int kWin, bool kRethresh, bool kGlr, typename T>
__device__ __forceinline__ void edge_sums(const float* Sg, const float* Sl, float* Ag, float* Al,
                                          const Region& R, const T* __restrict__ wg,
                                          const T* __restrict__ wl, size_t n, float gamma) {
  for_region(R, [&](int p, int i, int j) {
    Ag[p] = gtv_edge_sum<kWin, kRethresh>(Sg, R, wg, n, i, j, gamma);
    if (kGlr) Al[p] = glr_lap<kWin>(Sl, R, wl, n, i, j);
  });
}

// Element loads of a step's planes: plain, or through L2 only (ld.global.cg)
// for planes that CTAs of the same launch wrote before a grid barrier (K1's
// scratch), which the non-coherent read-only path must not serve.
template <bool kL2>
__device__ __forceinline__ float load(const float* p) { return kL2 ? __ldcg(p) : *p; }
template <bool kL2>
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(kL2 ? __ldcg(p) : *p);
}

// One step's coefficients for one graph; x_coef scales x_add (below).
struct Coefs {
  float mu0, ro0, mu1, ro1, alpha, beta, gam0, gam1, x_coef;
};

// One step's planes, each (B, G*F, H, W), and its weights (B, G, E, H, W) /
// (B, G, E, H/2, W/2) in T. The input is x, or x + x_coef * x_add when
// the IO's kXAdd is set (x_coef from the graph's Coefs); aux, prev, out and
// upd may be null. Each plane has its own element type: K1 carries f32
// between its steps and reads and writes T at its ends.
template <typename T_, typename TX_, typename TA_, typename TP_, typename TO_, typename TU_,
          bool kL2_, bool kXAdd_ = false>
struct StepIO {
  using T = T_;
  using TX = TX_;
  using TA = TA_;
  using TP = TP_;
  using TO = TO_;
  using TU = TU_;
  static constexpr bool kL2 = kL2_;      // read x, aux, prev through L2
  static constexpr bool kXAdd = kXAdd_;  // x_add is set
  const TX* x;
  const float* x_add;
  const TA* aux;
  const TP* prev;
  TO* out;
  TU* upd;
  const T *wg0, *wl0, *wg1, *wl1;
  const float *pg0, *pl0, *pg1, *pl1;  // (G, 4, F) stats tables
  int G, F, H, W, epi, use_x_rhs;
  int pad;  // the stencil's pad (kPadEdge, kPadZero, kPadReflect), read with kAnyPad
};

// The step on the output tile with top-left pixel (ti0, tj0) of channel
// plane `plane` = (b * G + g) * F + f on window kWin, the stencil padded by
// "edge" or, with kAnyPad, by io.pad; smem holds kTileSmem bytes. Ends with
// a barrier, so the caller may start the next tile.
template <int kWin, bool kAnyPad, bool kRethresh, bool kGlr, class IO>
__device__ __forceinline__ void step_tile(const IO& io, const Coefs& k, int plane, int ti0,
                                          int tj0, float* smem) {
  constexpr int E = ptile::Win<kWin>::E;
  constexpr bool kL2 = IO::kL2;
  using T = typename IO::T;
  const int f = plane % io.F, bg = plane / io.F, g = bg % io.G;
  const int H = io.H, W = io.W, H2 = H / 2, W2 = W / 2;
  const size_t n0 = (size_t)H * W, n1 = (size_t)H2 * W2;
  const int ti1 = min(ti0 + kTH, H), tj1 = min(tj0 + kTW, W);
  const Region R0 = region(ti0, ti1, tj0, tj1, H, W);
  const Region R1 = region(ti0 / 2, ti1 / 2, tj0 / 2, tj1 / 2, H2, W2);

  float* X = smem;
  float* Sg = X + kR0;
  float* Ag = Sg + kR0;
  float* Sl = Ag + kR0;
  float* Al = Sl + (kGlr ? kR0 : 0);
  float* XD = Al + (kGlr ? kR0 : 0);  // T1 (the half tile's result) once XD is read
  float* Sg1 = XD + kR1;
  float* Ag1 = Sg1 + kR1;
  float* Sl1 = Ag1 + kR1;
  float* Al1 = Sl1 + (kGlr ? kR1 : 0);

  // The planes a step reads are not written while it runs (K1 writes its
  // scratch in other phases and reads it through L2 explicitly), so they are
  // declared restrict: the compiler may then schedule their loads freely.
  const size_t base = plane * n0;
  const auto* __restrict__ x = io.x + base;
  const float* __restrict__ xa = IO::kXAdd ? io.x_add + base : nullptr;
  const auto* __restrict__ aux = io.aux;
  const auto* __restrict__ prev = io.prev;
  const float x_coef = k.x_coef;
  auto xat = [&](size_t idx) {
    const float v = load<kL2>(x + idx);
    return IO::kXAdd ? fmaf(x_coef, load<kL2>(xa + idx), v) : v;
  };
  const T* __restrict__ wg0 = io.wg0 + bg * E * n0;
  const T* __restrict__ wl0 = kGlr ? io.wl0 + bg * E * n0 : nullptr;
  const T* __restrict__ wg1 = io.wg1 + bg * E * n1;
  const T* __restrict__ wl1 = kGlr ? io.wl1 + bg * E * n1 : nullptr;
  const Stats sg0 = load_stats(io.pg0, g, io.F, f);
  const Stats sl0 = kGlr ? load_stats(io.pl0, g, io.F, f) : Stats{};
  const Stats sg1 = load_stats(io.pg1, g, io.F, f);
  const Stats sl1 = kGlr ? load_stats(io.pl1, g, io.F, f) : Stats{};

  // 1. x over the region; its 2x2 box mean over the half region
  for_region(R0, [&](int p, int i, int j) { X[p] = xat((size_t)i * W + j); });
  for_region(R1, [&](int p, int i, int j) {
    const size_t b = (size_t)(2 * i) * W + 2 * j;
    XD[p] = 0.25f * (xat(b) + xat(b + 1) + xat(b + W) + xat(b + W + 1));
  });
  __syncthreads();
  // 2. the stencils
  stencils<kAnyPad, kGlr>(X, Sg, Sl, R0, sg0, sl0, io.pad);
  stencils<kAnyPad, kGlr>(XD, Sg1, Sl1, R1, sg1, sl1, io.pad);
  __syncthreads();
  // 3. the edge sums
  edge_sums<kWin, kRethresh, kGlr>(Sg, Sl, Ag, Al, R0, wg0, wl0, n0, k.gam0);
  edge_sums<kWin, kRethresh, kGlr>(Sg1, Sl1, Ag1, Al1, R1, wg1, wl1, n1, k.gam1);
  __syncthreads();
  // 4. the half tile's term, into XD's space
  const int hi0 = ti0 / 2, hj0 = tj0 / 2, tw2 = (tj1 - tj0) / 2;
  float* T1 = XD;
  const int nt1 = (ti1 - ti0) / 2 * tw2;
  for (int q = threadIdx.x; q < nt1; q += kThreads) {
    const int qi = q / tw2, i = hi0 + qi, j = hj0 + q - qi * tw2;
    float t = k.ro1 * stats_t_at(Ag1, R1, sg1, i, j);
    if (kGlr) t += k.mu1 * stats_t_at(Al1, R1, sl1, i, j);
    T1[q] = t;
  }
  __syncthreads();
  // 5. the tile: T and the epilogue
  const int tw = tj1 - tj0, nt = (ti1 - ti0) * tw;
  for (int q = threadIdx.x; q < nt; q += kThreads) {
    const int qi = q / tw, i = ti0 + qi, j = tj0 + q - qi * tw;
    float t = k.ro0 * stats_t_at(Ag, R0, sg0, i, j);
    if (kGlr) t += k.mu0 * stats_t_at(Al, R0, sl0, i, j);
    t += 0.25f * T1[(i / 2 - hi0) * tw2 + (j / 2 - hj0)];
    const float xv = X[R0.at(i, j)];
    const size_t idx = base + (size_t)i * W + j;
    float o;
    if (io.epi == kEpiAddX) {
      o = xv + t;
    } else if (io.epi == kEpiAddAux) {
      o = aux != nullptr ? t + load<kL2>(aux + idx) : t;
    } else {  // CG: upd = rhs - A x [+ beta prev], out = x + alpha upd
      const float rhs = io.use_x_rhs ? xv : load<kL2>(aux + idx);
      float u = rhs - (xv + t);
      if (prev != nullptr) u += k.beta * load<kL2>(prev + idx);
      if (io.upd != nullptr) st(io.upd + idx, u);
      o = fmaf(k.alpha, u, xv);
    }
    if (io.out != nullptr) st(io.out + idx, o);
  }
  __syncthreads();
}

}  // namespace step
}  // namespace irdu
