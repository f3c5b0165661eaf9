// K8's kernel (see pixel_nhwc.cu): the templates, and the entry points of one
// window, instantiated in pixel_nhwc.cu (diamond-12), pixel_nhwc_cross4.cu and
// pixel_nhwc_ring8.cu.
#pragma once

#include "padded_tile.cuh"

namespace irdu {
namespace nhwc {

using namespace irdu::ptile;

constexpr int kRhs = 0, kCg1 = 1, kCg2 = 2, kRethresh = 3;  // as in ops/pixel_nhwc.py

// Tile plans of every window, as ops/pixel_nhwc.py's K8_PLANS: {rows,
// columns, graphs, threads}.
struct Plan {
  int th, tw, lanes, threads;
};
constexpr int kNumPlans = 2;
constexpr Plan plan_at(int i) {
  constexpr Plan plans[kNumPlans] = {{16, 32, 2, 256}, {16, 32, 4, 256}};
  return plans[i];
}

// Plane boxes: the tile with halo HS = 1 + r (stencil outputs, weights, edge
// sums); the x box with halo HX = 2 + r; r the window's radius.
template <int kWin, int kTH, int kTW>
struct Geo {
  static constexpr int HS = 1 + Win<kWin>::R, HX = 2 + Win<kWin>::R;
  static constexpr int PH = kTH + 2 * HS, PW = kTW + 2 * HS, NP = PH * PW;
  static constexpr int XH = kTH + 2 * HX, XW = kTW + 2 * HX, NX = XH * XW;
};

// Shared memory (bytes, each part 16-aligned): f32 planes Sg, Ag[, Sl, Al]
// of kN lanes a cell, two x boxes, the weights [e][cell][lane] gtv[, glr].
template <typename T, int kWin, bool kGlr, int kTH, int kTW, int kN>
struct Layout {
  using G = Geo<kWin, kTH, kTW>;
  static constexpr int NA = kGlr ? 2 : 1, kE = Win<kWin>::E;
  static constexpr size_t kPlanes = up16(sizeof(float) * 2 * NA * G::NP * kN);
  static constexpr size_t kX = up16(sizeof(T) * G::NX * kN);
  static constexpr size_t kW = up16(sizeof(T) * NA * kE * G::NP * kN);
  static constexpr size_t kBytes = kPlanes + 2 * kX + kW;
};

struct Args {
  const void *x, *aux, *prev, *wg, *wl;
  const float* p;     // (2, 4): the GTV and GLR stencil coefficients
  const float* scal;  // (5, C): planar rows mu, rho, gamma, alpha, beta
  void *out, *upd;
  int H, W, G, F, tiles_w;
  int whole;  // G is a multiple of the plan's lanes (set at launch)
};

// The kN lanes from src (cn of them valid) to dst: one cp.async where the
// groups are whole and aligned (vec), else lane by lane, zero past cn.
template <int kN, typename T>
__device__ __forceinline__ void fetch_lanes(T* dst, const T* src, int cn, bool vec) {
  if (vec) {
    copy_lanes<kN>(dst, src);
    return;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) dst[n] = n < cn ? src[n] : zero<T>();
}

// Whole groups (G a multiple of kN: every group whole, its lanes aligned) take
// vector accesses: always with kVec, else where a.whole says so (one instance
// for both, plan 0).
template <typename T, int kWin, int kMode, int kTH, int kTW, int kN, int kNT, bool kVec>
__global__ void __launch_bounds__(kNT) segment_kernel(const Args a) {
  const bool vec = kVec || a.whole != 0;
  constexpr bool kGlr = kMode == kCg1 || kMode == kCg2;
  constexpr bool kRe = kMode == kRethresh;
  constexpr int kE = Win<kWin>::E;
  using G = Geo<kWin, kTH, kTW>;
  using L = Layout<T, kWin, kGlr, kTH, kTW, kN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Sg = reinterpret_cast<float*>(smem);
  float* Ag = Sg + G::NP * kN;
  float* Sl = Ag + G::NP * kN;  // cg only
  float* Al = Sl + G::NP * kN;
  unsigned char* xbox = smem + L::kPlanes;  // two buffers of L::kX bytes
  T* Wg = reinterpret_cast<T*>(smem + L::kPlanes + 2 * L::kX);
  T* Wl = Wg + kE * G::NP * kN;

  const int H = a.H, W = a.W, Gn = a.G, C = a.F * Gn, EG = kE * Gn;
  const int g0 = blockIdx.x * kN, cn = min(kN, Gn - g0);
  const int ty = blockIdx.y / a.tiles_w, tx = blockIdx.y - ty * a.tiles_w;
  const int ti0 = ty * kTH, tj0 = tx * kTW;
  const int oi = ti0 - G::HS, oj = tj0 - G::HS, xi0 = ti0 - G::HX, xj0 = tj0 - G::HX;
  const size_t pix0 = (size_t)blockIdx.z * H * W;

  // the group's weights, once for all F features; feature 0's x box
  auto stage_weights = [&](T* dst, const void* src) {
    const T* w = static_cast<const T*>(src) + g0;
    for_box<kNT, kE * G::PH, G::PW>([&](int er, int c) {
      const int e = er / G::PH, gi = oi + er - e * G::PH, gj = oj + c;
      T* d = dst + (er * G::PW + c) * kN;
      if (gi < 0 || gi >= H || gj < 0 || gj >= W) {
#pragma unroll
        for (int n = 0; n < kN; ++n) d[n] = zero<T>();
      } else {
        fetch_lanes<kN>(d, w + (pix0 + (size_t)gi * W + gj) * EG + e * Gn, cn, vec);
      }
    });
  };
  auto stage_x = [&](T* dst, int f) {
    const T* x = static_cast<const T*>(a.x) + f * Gn + g0;
    for_box<kNT, G::XH, G::XW>([&](int r, int c) {
      const int gi = pad_index(xi0 + r, H, true), gj = pad_index(xj0 + c, W, true);
      fetch_lanes<kN>(dst + (r * G::XW + c) * kN, x + (pix0 + (size_t)gi * W + gj) * C, cn,
                      vec);
    });
  };
  stage_weights(Wg, a.wg);
  if (kGlr) stage_weights(Wl, a.wl);
  stage_x(reinterpret_cast<T*>(xbox), 0);
  cp_async_commit();

  Stats pg, pl;
#pragma unroll
  for (int k = 0; k < 4; ++k) pg.p[k] = a.p[k], pl.p[k] = a.p[4 + k];

  for (int f = 0; f < a.F; ++f) {
    cp_async_wait_all();
    __syncthreads();  // feature f's x box (and the weights) landed; feature f - 1 is done
    const T* X = reinterpret_cast<const T*>(xbox + (f & 1) * L::kX);
    if (f + 1 < a.F) {
      stage_x(reinterpret_cast<T*>(xbox + ((f + 1) & 1) * L::kX), f + 1);
      cp_async_commit();
    }
    // the epilogue's reads (aux, prev) of this thread's pixels, issued now so
    // that they arrive while the stencils and edge sums run
    T* out = static_cast<T*>(a.out);
    T* upd = static_cast<T*>(a.upd);
    constexpr int kPix = kTH * kTW, kPer = (kPix + kNT - 1) / kNT;
    constexpr bool kAux = kMode == kCg2 || kMode == kRethresh, kPrev = kMode == kCg2;
    auto index = [&](int q) {  // the pixel's first lane in x, or -1 past the tile or image
      const int r = q / kTW, c = q - r * kTW, gi = ti0 + r, gj = tj0 + c;
      return q < kPix && gi < H && gj < W
                 ? (long long)(pix0 + (size_t)gi * W + gj) * C + f * Gn + g0
                 : -1ll;
    };
    auto store = [&](void* base, long long idx, const float (&v)[kN]) {
      T* q = static_cast<T*>(base) + idx;
      if (vec) {
        st_lanes<kN>(q, v);
      } else {
#pragma unroll
        for (int n = 0; n < kN; ++n)
          if (n < cn) st(q + n, v[n]);
      }
    };
    // (whole groups: one vector load a pixel; else lane by lane, the lanes
    // past the group's last graph reading its last one), converted only
    // where the epilogue uses them
    Raw<kN, T> y[kPer], pv[kPer];
    auto fetch = [&](const void* base, long long idx, Raw<kN, T>& r) {
      const T* q = static_cast<const T*>(base) + idx;
      if (vec) {
        r = *reinterpret_cast<const Raw<kN, T>*>(q);
      } else {
#pragma unroll
        for (int n = 0; n < kN; ++n) r.v[n] = q[min(n, cn - 1)];
      }
    };
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long idx = index(threadIdx.x + k * kNT);
      if (idx < 0) continue;
      if (kAux) fetch(a.aux, idx, y[k]);
      if (kPrev) fetch(a.prev, idx, pv[k]);
    }
    // this feature's per-channel scalars (lanes past the group's last graph
    // take its last one's; their results are not stored)
    float mu[kN], ro[kN], gam[kN], alpha[kN], beta[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int ch = f * Gn + g0 + min(n, cn - 1);
      mu[n] = a.scal[ch];
      ro[n] = a.scal[C + ch];
      gam[n] = a.scal[2 * C + ch];
      alpha[n] = a.scal[3 * C + ch];
      beta[n] = a.scal[4 * C + ch];
    }
    // 2. the stencils over the tile + HS, at the pixel clamped to the image
    for_box<kNT, G::PH, G::PW>([&](int r, int c) {
      const int ci = clampi(oi + r, H), cj = clampi(oj + c, W);
      stencil_cell<kN, G::XW, kGlr>(X, (ci - xi0) * G::XW + (cj - xj0), pg, pl, Sg, Sl,
                                    r * G::PW + c);
    });
    __syncthreads();
    // 3. the edge sums over the tile + 1, zero outside the image
    for_box<kNT, kTH + 2, kTW + 2>([&](int r, int c) {
      const int pc = (r + G::HS - 1) * G::PW + c + G::HS - 1;
      const int gi = ti0 - 1 + r, gj = tj0 - 1 + c;
      if (gi < 0 || gi >= H || gj < 0 || gj >= W)
        zero_cell<kN, kGlr>(Ag, Al, pc);
      else
        edge_cell<kN, kWin, kRe, kGlr, G::PW, G::NP>(Sg, Sl, Wg, Wl, pc, gam, Ag, Al);
    });
    __syncthreads();
    // 4. the tile, a pixel's kN lanes a thread: t and the segment's epilogue
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = threadIdx.x + k * kNT;
      const long long idx = index(q);
      if (idx < 0) continue;
      const int r = q / kTW, c = q - r * kTW;
      const int pc = (r + G::HS) * G::PW + c + G::HS;
      float t[kN], tl[kN], xv[kN], o[kN];
      stats_t_cell<kN, G::PW>(Ag, pc, pg, t);
      if (kGlr) stats_t_cell<kN, G::PW>(Al, pc, pl, tl);
      ld_lanes<kN>(X + ((r + G::HX) * G::XW + c + G::HX) * kN, xv);
#pragma unroll
      for (int n = 0; n < kN; ++n) t[n] = kGlr ? mu[n] * tl[n] + ro[n] * t[n] : ro[n] * t[n];
      if (kMode == kRhs) {
#pragma unroll
        for (int n = 0; n < kN; ++n) o[n] = xv[n] + t[n];
      } else if (kMode == kRethresh) {
        float yv[kN];
        y[k].get(yv);
#pragma unroll
        for (int n = 0; n < kN; ++n) o[n] = yv[n] + t[n];
      } else if (kMode == kCg1) {
        float u[kN];
#pragma unroll
        for (int n = 0; n < kN; ++n) u[n] = -t[n], o[n] = xv[n] + alpha[n] * u[n];
        store(upd, idx, u);
      } else {
        float rhs[kN], pr[kN];
        y[k].get(rhs);
        pv[k].get(pr);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float u = rhs[n] - xv[n] - t[n] + beta[n] * pr[n];
          o[n] = xv[n] + alpha[n] * u;
        }
      }
      store(out, idx, o);
    }
  }
}

template <typename T, int kWin, int kMode, int kPlan, bool kVec>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr Plan p = plan_at(kPlan);
  constexpr size_t smem =
      Layout<T, kWin, kMode == kCg1 || kMode == kCg2, p.th, p.tw, p.lanes>::kBytes;
  auto kern = segment_kernel<T, kWin, kMode, p.th, p.tw, p.lanes, p.threads, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args b = a;
  b.tiles_w = (a.W + p.tw - 1) / p.tw;
  b.whole = a.G % p.lanes == 0;
  const int tiles = b.tiles_w * ((a.H + p.th - 1) / p.th);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.G + p.lanes - 1) / p.lanes, tiles, B);
  kern<<<grid, p.threads, smem, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kWin, int kPlan, bool kVec>
int dispatch_mode(const Args& a, int B, int mode, cudaStream_t s) {
  switch (mode) {
    case kRhs: return launch<T, kWin, kRhs, kPlan, kVec>(a, B, s);
    case kCg1: return launch<T, kWin, kCg1, kPlan, kVec>(a, B, s);
    case kCg2: return launch<T, kWin, kCg2, kPlan, kVec>(a, B, s);
    case kRethresh: return launch<T, kWin, kRethresh, kPlan, kVec>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Both plans in bf16, plan 0 in f32; whole graph groups (G a multiple of
// the plan's lanes) on both plans, partial ones on plan 0, whose one
// instance takes both.
template <typename T, int kWin>
int dispatch(const Args& a, int B, int mode, int plan, cudaStream_t s) {
  const bool whole = a.G % plan_at(plan).lanes == 0;
  if (plan == 0) return dispatch_mode<T, kWin, 0, false>(a, B, mode, s);
  if constexpr (sizeof(T) == 2) {
    if (whole && plan == 1) return dispatch_mode<T, kWin, 1, true>(a, B, mode, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int kWin, int kPlan>
long long plan_bytes(bool glr) {
  constexpr Plan p = plan_at(kPlan);
  return static_cast<long long>(glr ? Layout<T, kWin, true, p.th, p.tw, p.lanes>::kBytes
                                    : Layout<T, kWin, false, p.th, p.tw, p.lanes>::kBytes);
}

template <typename T, int kWin>
long long smem_of(bool glr, int plan) {
  if (plan < 0 || plan >= kNumPlans) return -1;
  return plan == 0 ? plan_bytes<T, kWin, 0>(glr) : plan_bytes<T, kWin, 1>(glr);
}

// One window's entry points. Each window's instances are compiled in a
// translation unit of their own (pixel_nhwc.cu for diamond-12, pixel_nhwc_cross4.cu,
// pixel_nhwc_ring8.cu), so that nvcc builds the windows side by side; pixel_nhwc.cu's
// C interface picks one.
struct Entry {
  int (*run)(const Args& a, int B, int mode, int plan, int dtype, cudaStream_t s);
  long long (*smem)(bool glr, int plan, int dtype);
};

template <int kWin>
int run_window(const Args& a, int B, int mode, int plan, int dtype, cudaStream_t s) {
  if (dtype == kFloat32) return dispatch<float, kWin>(a, B, mode, plan, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16, kWin>(a, B, mode, plan, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kWin>
long long smem_window(bool glr, int plan, int dtype) {
  if (dtype == kFloat32) return smem_of<float, kWin>(glr, plan);
  if (dtype == kBFloat16) return smem_of<__nv_bfloat16, kWin>(glr, plan);
  return -1;
}

template <int kWin>
constexpr Entry entry_of() {
  return Entry{&run_window<kWin>, &smem_window<kWin>};
}

extern const Entry kCross4Entry, kDiamond12Entry, kRing8Entry;

}  // namespace nhwc
}  // namespace irdu

