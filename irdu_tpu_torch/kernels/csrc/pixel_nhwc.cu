// K8: one fused segment of the pixel-family unroll (rhs, cg1, cg2 or
// rethresh), channels-last, diamond-12, the stencil's reflect pad. Replaces
// irdu_tpu/ops/pallas/pixel_nhwc.py:pixel_segment_nhwc (_kernel). The math,
// the layouts and the bound are set out in irdu_tpu_torch/ops/pixel_nhwc.py;
// the padded tile's stages and boundary rules in padded_tile.cuh.
//
// Signals are (B, H, W, C = F*G) in planar order c = f*G + g; the edge weights
// are packed (B, H, W, 12*G), index e*G + g, and broadcast over f. A CTA
// takes one kTH x kTW output tile of a group of kN graphs (the CTAs of a
// tile's groups are neighbours in the grid, so they share its rows in L2)
// and walks the F features:
//   - the group's 12 edge weights of the tile (kN lanes of each packed row,
//     one cp.async of 4-16 bytes a pixel and edge) come into shared memory
//     once and serve all F features;
//   - feature f + 1's x box (kN lanes a pixel, from the reflected pixel past
//     the image edge) comes by cp.async into the second of two buffers while
//     feature f computes, and stays there for the epilogue;
//   - every stage works on a pixel's kN lanes with vector shared-memory
//     accesses; stage planes are [cell][lane].
// The tile's halo is 4 (stencil 1, edge sum 2, stencil^T 1): a 16x32 tile
// computes its stencils on 22x38 cells (1.63x the outputs; 3.0x with the
// 8x16 tiles of the first port). Shared memory (bf16, cg, 16x32, 4 lanes,
// the served plan): 229,376 bytes, one CTA an SM. Bound by bytes (the
// weights are 4/3 of a cg segment's).

#include "padded_tile.cuh"

namespace irdu {
namespace nhwc {

using namespace irdu::ptile;

constexpr int kRhs = 0, kCg1 = 1, kCg2 = 2, kRethresh = 3;  // as in ops/pixel_nhwc.py
constexpr int kE = kDiamondEdges;

// Tile plans, as ops/pixel_nhwc.py's K8_PLANS: {rows, columns, graphs, threads}.
struct Plan {
  int th, tw, lanes, threads;
};
constexpr int kNumPlans = 3;
constexpr Plan plan_at(int i) {
  constexpr Plan plans[kNumPlans] = {{16, 32, 2, 256}, {16, 32, 4, 256}, {32, 32, 2, 256}};
  return plans[i];
}

// Plane boxes: the tile with halo 3 (stencil outputs, weights, edge sums);
// the x box with halo 4.
template <int kTH, int kTW>
struct Geo {
  static constexpr int HS = 3, HX = 4;
  static constexpr int PH = kTH + 2 * HS, PW = kTW + 2 * HS, NP = PH * PW;
  static constexpr int XH = kTH + 2 * HX, XW = kTW + 2 * HX, NX = XH * XW;
};

// Shared memory (bytes, each part 16-aligned): f32 planes Sg, Ag[, Sl, Al]
// of kN lanes a cell, two x boxes, the weights [e][cell][lane] gtv[, glr].
template <typename T, bool kGlr, int kTH, int kTW, int kN>
struct Layout {
  using G = Geo<kTH, kTW>;
  static constexpr int NA = kGlr ? 2 : 1;
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
};

// The kN lanes from src (cn of them valid) to dst: one cp.async where the
// groups are whole and aligned (kVec), else lane by lane, zero past cn.
template <int kN, bool kVec, typename T>
__device__ __forceinline__ void fetch_lanes(T* dst, const T* src, int cn) {
  if (kVec) {
    copy_lanes<kN>(dst, src);
    return;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) dst[n] = n < cn ? src[n] : zero<T>();
}

// kVec: G is a multiple of kN, so every group is whole and its lanes aligned.
template <typename T, int kMode, int kTH, int kTW, int kN, int kNT, bool kVec>
__global__ void __launch_bounds__(kNT) segment_kernel(const Args a) {
  constexpr bool kGlr = kMode == kCg1 || kMode == kCg2;
  constexpr bool kRe = kMode == kRethresh;
  using G = Geo<kTH, kTW>;
  using L = Layout<T, kGlr, kTH, kTW, kN>;
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
        fetch_lanes<kN, kVec>(d, w + (pix0 + (size_t)gi * W + gj) * EG + e * Gn, cn);
      }
    });
  };
  auto stage_x = [&](T* dst, int f) {
    const T* x = static_cast<const T*>(a.x) + f * Gn + g0;
    for_box<kNT, G::XH, G::XW>([&](int r, int c) {
      const int gi = pad_index(xi0 + r, H, true), gj = pad_index(xj0 + c, W, true);
      fetch_lanes<kN, kVec>(dst + (r * G::XW + c) * kN, x + (pix0 + (size_t)gi * W + gj) * C,
                            cn);
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
      if (kVec) {
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
      if (kVec) {
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
    // 2. the stencils over the tile + 3, at the pixel clamped to the image
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
        edge_cell<kN, 1, kRe, kGlr, G::PW, G::NP>(Sg, Sl, Wg, Wl, pc, gam, Ag, Al);
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

template <typename T, int kMode, int kPlan, bool kVec>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr Plan p = plan_at(kPlan);
  constexpr size_t smem =
      Layout<T, kMode == kCg1 || kMode == kCg2, p.th, p.tw, p.lanes>::kBytes;
  auto kern = segment_kernel<T, kMode, p.th, p.tw, p.lanes, p.threads, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args b = a;
  b.tiles_w = (a.W + p.tw - 1) / p.tw;
  const int tiles = b.tiles_w * ((a.H + p.th - 1) / p.th);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.G + p.lanes - 1) / p.lanes, tiles, B);
  kern<<<grid, p.threads, smem, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kPlan, bool kVec>
int dispatch_mode(const Args& a, int B, int mode, cudaStream_t s) {
  switch (mode) {
    case kRhs: return launch<T, kRhs, kPlan, kVec>(a, B, s);
    case kCg1: return launch<T, kCg1, kPlan, kVec>(a, B, s);
    case kCg2: return launch<T, kCg2, kPlan, kVec>(a, B, s);
    case kRethresh: return launch<T, kRethresh, kPlan, kVec>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Every plan in bf16, plan 0 in f32; whole graph groups (G a multiple of the
// plan's lanes) on every plan, partial ones on plan 0.
template <typename T>
int dispatch(const Args& a, int B, int mode, int plan, cudaStream_t s) {
  const bool whole = a.G % plan_at(plan).lanes == 0;
  if (plan == 0)
    return whole ? dispatch_mode<T, 0, true>(a, B, mode, s)
                 : dispatch_mode<T, 0, false>(a, B, mode, s);
  if constexpr (sizeof(T) == 2) {
    if (whole && plan == 1) return dispatch_mode<T, 1, true>(a, B, mode, s);
    if (whole && plan == 2) return dispatch_mode<T, 2, true>(a, B, mode, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int kPlan>
long long plan_bytes(bool glr) {
  constexpr Plan p = plan_at(kPlan);
  return static_cast<long long>(glr ? Layout<T, true, p.th, p.tw, p.lanes>::kBytes
                                    : Layout<T, false, p.th, p.tw, p.lanes>::kBytes);
}

template <typename T>
long long smem_of(bool glr, int plan) {
  switch (plan) {
    case 0: return plan_bytes<T, 0>(glr);
    case 1: return plan_bytes<T, 1>(glr);
    case 2: return plan_bytes<T, 2>(glr);
    default: return -1;
  }
}

}  // namespace nhwc
}  // namespace irdu

// x, aux, prev, out, upd (B, H, W, F*G) and wg, wl (B, H, W, 12*G) in one
// dtype; p (2, 4) and scal (5, F*G) f32. rhs reads x, wg; cg1 x, wg, wl and
// writes upd; cg2 x, aux, prev, wg, wl; rethresh x, aux, wg. plan: the tile
// plan (ops/pixel_nhwc.py K8_PLANS; plans 1-2 in bf16 only).
extern "C" int irdu_pixel_segment(const void* x, const void* aux, const void* prev,
                                  const void* wg, const void* wl, const void* p,
                                  const void* scal, void* out, void* upd, int B, int H, int W,
                                  int G, int F, int mode, int plan, int dtype, void* stream) {
  using namespace irdu::nhwc;
  const bool glr = mode == kCg1 || mode == kCg2;
  const bool bad =
      B < 1 || B > 65535 || H < 2 || W < 2 || G < 1 || F < 1 || mode < kRhs ||
      mode > kRethresh || plan < 0 || plan >= kNumPlans || x == nullptr || wg == nullptr ||
      p == nullptr || scal == nullptr || out == nullptr || (glr && wl == nullptr) ||
      (mode == kCg1 && upd == nullptr) || ((mode == kCg2 || mode == kRethresh) && aux == nullptr) ||
      (mode == kCg2 && prev == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, aux, prev, wg, wl, static_cast<const float*>(p),
               static_cast<const float*>(scal), out, upd, H, W, G, F, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == irdu::kFloat32) return dispatch<float>(a, B, mode, plan, s);
  if (dtype == irdu::kBFloat16) return dispatch<__nv_bfloat16>(a, B, mode, plan, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory one CTA of the kernel takes in a mode with GLR (cg1,
// cg2) or without, or -1 for a plan it does not have.
extern "C" long long irdu_pixel_segment_smem(int glr, int plan, int dtype) {
  using namespace irdu::nhwc;
  if (dtype == irdu::kFloat32) return smem_of<float>(glr, plan);
  if (dtype == irdu::kBFloat16) return smem_of<__nv_bfloat16>(glr, plan);
  return -1;
}
