// K7's kernel (see pixel_unroll.cu): the templates, and the entry points of
// one window, instantiated in pixel_unroll.cu (diamond-12),
// pixel_unroll_cross4.cu and pixel_unroll_ring8.cu.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "padded_tile.cuh"

namespace irdu {
namespace pix {

namespace cg = cooperative_groups;
using namespace irdu::ptile;

enum Kind { kRhs, kCgFirst, kCgNext, kRethresh };

// The tile of each type, as ops/pixel_unroll.py's K7_TILES: {rows, columns,
// threads, CTAs an SM}. bf16 takes 32x64 tiles of 512 threads, the fastest
// of 16x64, 32x64 and 32x64 of 256 threads on the card (PERF.md, K7's design
// note); f32 takes 16x64 tiles of 256 threads, as a 32x64 tile's f32 weights
// would not fit.
struct Tile {
  int th, tw, threads, ctas;
};
template <typename T>
constexpr Tile tile_of() {
  return sizeof(T) == 2 ? Tile{32, 64, 512, 1} : Tile{16, 64, 256, 1};
}

// The boxes of a tile: stage planes with halo HS = 1 + r rows and HSC
// columns (HS rounded up to a multiple of 4, so that the weight boxes start
// on the 4-cell chunks stage_weights copies), r the window's radius; the x
// box with halo HXR = 2 + r rows and one 16-byte chunk of columns (8 bf16 or
// 4 f32), so that its rows start on 16-byte chunks.
template <int kWin, int kTH, int kTW>
struct Geo {
  static_assert(kTW % 8 == 0, "tiles start on 16-byte chunks");
  static constexpr int HS = 1 + Win<kWin>::R, HSC = (HS + 3) & ~3;
  static constexpr int PH = kTH + 2 * HS, PW = kTW + 2 * HSC, NP = PH * PW;
  static constexpr int HXR = 2 + Win<kWin>::R, XH = kTH + 2 * HXR;
  template <typename TX>
  __host__ __device__ static constexpr int hxc() { return 16 / static_cast<int>(sizeof(TX)); }
  template <typename TX>
  __host__ __device__ static constexpr int xw() { return kTW + 2 * hxc<TX>(); }
};

// Shared memory (bytes, each part 16-aligned): f32 planes Sg, Ag, Sl, Al;
// two x boxes, each large enough for y's type and for f32; the E weights
// [e][cell] gtv, glr in T.
template <typename T, int kWin, int kTH, int kTW>
struct Layout {
  using G = Geo<kWin, kTH, kTW>;
  static constexpr int kE = Win<kWin>::E;
  static constexpr size_t kPlanes = up16(sizeof(float) * 4 * G::NP);
  static constexpr size_t kXT = up16(sizeof(T) * G::XH * G::template xw<T>());
  static constexpr size_t kXF = up16(sizeof(float) * G::XH * G::template xw<float>());
  static constexpr size_t kX = kXT > kXF ? kXT : kXF;
  static constexpr size_t kW = up16(sizeof(T) * 2 * kE * G::NP);
  static constexpr size_t kBytes = kPlanes + 2 * kX + kW;
};

template <typename T>
struct Args {
  const T* y;            // (B, F, H, W)
  const T *wg, *wl;      // (B, G, E, H, W)
  const float *pg, *pl;  // (G, 4, F) stats tables
  const float* scal;     // (G, 9): mu, rho, gamma, a0, a1, a2, a3, b1, b3
  T* out;                // (B, G*F, H, W)
  float *P0, *P1, *P2;   // f32 scratch, each (B, G*F, H, W)
  int B, G, F, H, W;
};

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) { return __ldcg(p); }

// kPlanes planes of kRows x kCols cells from planes of an H x W image
// (plane stride n) at origin (r0, c0), zero outside the image; chunks of 4
// cells in the image by one cp.async (8 bytes in bf16, 16 in f32; c0, kCols
// and W multiples of 4).
template <typename T, int kPlanes, int kRows, int kCols, int kNT>
__device__ __forceinline__ void stage_weights(T* dst, const T* src, size_t n, int r0, int c0,
                                              int H, int W) {
  static_assert(kCols % 4 == 0, "whole chunks a row");
  const bool vec = (W & 3) == 0;
  for_box<kNT, kPlanes * kRows, kCols / 4>([&](int pr, int cp) {
    const int e = pr / kRows, r = pr - e * kRows;
    const int gi = r0 + r, gj = c0 + 4 * cp;
    T* d = dst + pr * kCols + 4 * cp;
    const bool row_in = gi >= 0 && gi < H;
    const T* s = src + e * n + (size_t)(row_in ? gi : 0) * W;
    if (vec && row_in && gj >= 0 && gj + 3 < W) {
      copy_lanes<4>(d, s + gj);
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = row_in && gj + k >= 0 && gj + k < W ? s[gj + k] : zero<T>();
  });
}

// A kRows x kCols box of one H x W plane at origin (r0, c0), each cell the
// pixel the reflect pad reads; 16-byte chunks inside the image by cp.async
// (c0, kCols and W multiples of the chunk), the rest through L2.
template <typename TX, int kRows, int kCols, int kNT>
__device__ __forceinline__ void stage_x(TX* dst, const TX* src, int r0, int c0, int H, int W) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(TX));
  static_assert(kCols % kChunk == 0, "whole chunks a row");
  const bool vec = W % kChunk == 0;
  for_box<kNT, kRows, kCols / kChunk>([&](int r, int ck) {
    const TX* row = src + (size_t)pad_index(r0 + r, H, true) * W;
    const int gj = c0 + kChunk * ck;
    TX* d = dst + r * kCols + kChunk * ck;
    if (vec && gj >= 0 && gj + kChunk <= W) {
      cp_async<16>(d, row + gj);
      return;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) d[k] = ldcg(row + pad_index(gj + k, W, true));
  });
}

// One phase: the padded tile on every (b, g, tile) item this CTA takes,
// walking the item's F planes. x: the plane read over a box (y for kRhs,
// else f32 scratch); rhs, prev: read at the tile's pixels (kCgNext); o: the
// output plane; u: the CG update (kCgFirst); alpha, beta: scal columns.
template <int kKind, int kWin, typename T, typename TX, typename TO, int kTH, int kTW, int kNT>
__device__ __forceinline__ void phase(const Args<T>& a, const TX* x, const float* rhs,
                                      const float* prev, TO* o, float* u, int alpha_k, int beta_k,
                                      unsigned char* smem) {
  using G = Geo<kWin, kTH, kTW>;
  using L = Layout<T, kWin, kTH, kTW>;
  constexpr int kE = Win<kWin>::E;
  constexpr bool kGlr = kKind == kCgFirst || kKind == kCgNext;
  constexpr bool kRe = kKind == kRethresh;
  constexpr int XW = G::template xw<TX>(), HXC = G::template hxc<TX>();
  float* Sg = reinterpret_cast<float*>(smem);
  float* Ag = Sg + G::NP;
  float* Sl = Ag + G::NP;
  float* Al = Sl + G::NP;
  unsigned char* xbox = smem + L::kPlanes;  // two buffers of L::kX bytes
  T* Wg = reinterpret_cast<T*>(smem + L::kPlanes + 2 * L::kX);
  T* Wl = Wg + kE * G::NP;

  const int H = a.H, W = a.W, F = a.F;
  const size_t n = (size_t)H * W;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles = tiles_w * ((H + kTH - 1) / kTH);
  const int items = a.B * a.G * tiles;
  // an item's tile origin and x's plane 0: y's (b, 0), or the scratch plane (b, g, 0)
  auto item_at = [&](int it, int& bg, int& ti0, int& tj0, const TX*& xp) {
    bg = it / tiles;
    const int tile = it - bg * tiles, ty = tile / tiles_w;
    ti0 = ty * kTH;
    tj0 = (tile - ty * tiles_w) * kTW;
    xp = x + (kKind == kRhs ? (size_t)(bg / a.G) * F : (size_t)bg * F) * n;
  };
  auto stage_item_weights = [&](int bg, int ti0, int tj0) {
    stage_weights<T, kE, G::PH, G::PW, kNT>(Wg, a.wg + (size_t)bg * kE * n, n, ti0 - G::HS,
                                            tj0 - G::HSC, H, W);
    if (kGlr)
      stage_weights<T, kE, G::PH, G::PW, kNT>(Wl, a.wl + (size_t)bg * kE * n, n, ti0 - G::HS,
                                              tj0 - G::HSC, H, W);
  };
  auto stage_box = [&](int buf, const TX* plane, int ti0, int tj0) {
    stage_x<TX, G::XH, XW, kNT>(reinterpret_cast<TX*>(xbox + buf * L::kX), plane, ti0 - G::HXR,
                                tj0 - HXC, H, W);
  };
  if (blockIdx.x >= items) return;
  // cp.async groups, in order: the x box of each step (committed at the top
  // of the step before), then the weights of an item (committed after the
  // edge sums of the item before: they load while its last epilogue and the
  // next item's first stencils run); every thread commits every group
  {
    int bg, ti0, tj0;
    const TX* xp;
    item_at(blockIdx.x, bg, ti0, tj0, xp);
    stage_box(0, xp, ti0, tj0);
    cp_async_commit();
    stage_item_weights(bg, ti0, tj0);
    cp_async_commit();
  }
  int buf = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int bg, ti0, tj0;
    const TX* xp;
    item_at(it, bg, ti0, tj0, xp);
    const int g = bg % a.G, b = bg / a.G, next = it + gridDim.x;
    const int oi = ti0 - G::HS, oj = tj0 - G::HSC;  // plane cell (0, 0)
    const int xi0 = ti0 - G::HXR, xj0 = tj0 - HXC;  // x box cell (0, 0)
    const float* sc = a.scal + g * 9;
    const float mu = sc[0], ro = sc[1];
    const float gam[1] = {sc[2]};
    const float alpha = alpha_k >= 0 ? sc[alpha_k] : 0.f, beta = beta_k >= 0 ? sc[beta_k] : 0.f;

    for (int f = 0; f < F; ++f, buf ^= 1) {
      cp_async_wait_group<1>();  // this step's x box (an item's weights may still load)
      __syncthreads();           // ... landed for every thread; the step before is done
      const TX* X = reinterpret_cast<const TX*>(xbox + buf * L::kX);
      if (f + 1 < F) {  // the next step's x box: this item's next plane, or the next item's first
        stage_box(buf ^ 1, xp + (f + 1) * n, ti0, tj0);
      } else if (next < items) {
        int nbg, nti0, ntj0;
        const TX* nxp;
        item_at(next, nbg, nti0, ntj0, nxp);
        stage_box(buf ^ 1, nxp, nti0, ntj0);
      }
      cp_async_commit();
      const Stats sg = load_stats(a.pg, g, F, f), sl = kGlr ? load_stats(a.pl, g, F, f) : Stats{};
      // the epilogue's reads of this thread's pixel pairs, issued now so that
      // they arrive while the stencils and edge sums run
      const size_t base = ((size_t)bg * F + f) * n;  // the (b, g, f) plane
      const T* yf = a.y + ((size_t)b * F + f) * n;
      constexpr int kBW = kTW / 2, kPairs = kTH * kBW, kPer = (kPairs + kNT - 1) / kNT;
      Raw<2, float> rv[kPer], pv[kPer];
      Raw<2, T> yv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int q = threadIdx.x + k * kNT, bi = q / kBW, bj = q - bi * kBW;
        const int gi = ti0 + bi, gj = tj0 + 2 * bj;
        if (q >= kPairs || gi >= H || gj >= W) continue;
        const size_t idx = (size_t)gi * W + gj;
        const int last = gj + 1 < W ? 1 : 0;
        if (kKind == kCgNext) {
          rv[k].v[0] = ldcg(rhs + base + idx);
          rv[k].v[1] = ldcg(rhs + base + idx + last);
          pv[k].v[0] = ldcg(prev + base + idx);
          pv[k].v[1] = ldcg(prev + base + idx + last);
        }
        if (kKind == kRethresh) {
          yv[k].v[0] = yf[idx];
          yv[k].v[1] = yf[idx + last];
        }
      }

      // 2. the stencils over the tile + HS, at the pixel clamped to the image
      constexpr int kSc = G::HSC - G::HS;  // the S box's first column
      for_box<kNT, G::PH, kTW + 2 * G::HS>([&](int r, int c) {
        const int ci = clampi(oi + r, H), cj = clampi(oj + c + kSc, W);
        stencil_cell<1, XW, kGlr>(X, (ci - xi0) * XW + (cj - xj0), sg, sl, Sg, Sl,
                                  r * G::PW + c + kSc);
      });
      if (f == 0) cp_async_wait_group<1>();  // the item's weights (the next x box may load)
      __syncthreads();
      // 3. the edge sums over the tile + 1, zero outside the image
      for_box<kNT, kTH + 2, kTW + 2>([&](int r, int c) {
        const int pc = (r + G::HS - 1) * G::PW + c + G::HSC - 1;
        const int gi = ti0 - 1 + r, gj = tj0 - 1 + c;
        if (gi < 0 || gi >= H || gj < 0 || gj >= W)
          zero_cell<1, kGlr>(Ag, Al, pc);
        else
          edge_cell<1, kWin, kRe, kGlr, G::PW, G::NP>(Sg, Sl, Wg, Wl, pc, gam, Ag, Al);
      });
      __syncthreads();
      if (f + 1 == F && next < items) {  // the weights are free: the next item's
        int nbg, nti0, ntj0;
        const TX* nxp;
        item_at(next, nbg, nti0, ntj0, nxp);
        stage_item_weights(nbg, nti0, ntj0);
      }
      cp_async_commit();
      // 4. the tile, a pixel pair a thread: t = rho stats^T(Ag) [+ mu stats^T(Al)]
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int q = threadIdx.x + k * kNT, bi = q / kBW, bj = q - bi * kBW;
        const int gi = ti0 + bi, gj = tj0 + 2 * bj;
        if (q >= kPairs || gi >= H || gj >= W) continue;
        const int pc = (G::HS + bi) * G::PW + G::HSC + 2 * bj;
        float t[2], tl[2], xv[2], ov[2], uv[2];
        stats_t_pair<G::PW>(Ag, pc, sg, t);
        if (kGlr) stats_t_pair<G::PW>(Al, pc, sl, tl);
#pragma unroll
        for (int d = 0; d < 2; ++d) t[d] = kGlr ? ro * t[d] + mu * tl[d] : ro * t[d];
        ld_lanes<2>(X + (bi + G::HXR) * XW + 2 * bj + HXC, xv);
        if (kKind == kRhs) {
#pragma unroll
          for (int d = 0; d < 2; ++d) ov[d] = xv[d] + t[d];
        } else if (kKind == kRethresh) {
          float yy[2];
          yv[k].get(yy);
#pragma unroll
          for (int d = 0; d < 2; ++d) ov[d] = yy[d] + t[d];
        } else if (kKind == kCgFirst) {  // x is the rhs: u = rhs - A x = -t
#pragma unroll
          for (int d = 0; d < 2; ++d) uv[d] = -t[d], ov[d] = fmaf(alpha, uv[d], xv[d]);
        } else {
          float rr[2], pp[2];
          rv[k].get(rr);
          pv[k].get(pp);
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            uv[d] = rr[d] - (xv[d] + t[d]) + beta * pp[d];
            ov[d] = fmaf(alpha, uv[d], xv[d]);
          }
        }
        const size_t idx = base + (size_t)gi * W + gj;
        const bool pair = gj + 1 < W && (idx & 1) == 0;
        if (pair) {
          st_lanes<2>(o + idx, ov);
          if (kKind == kCgFirst) st_lanes<2>(u + idx, uv);
        } else {
          st(o + idx, ov[0]);
          if (gj + 1 < W) st(o + idx + 1, ov[1]);
          if (kKind == kCgFirst) {
            st(u + idx, uv[0]);
            if (gj + 1 < W) st(u + idx + 1, uv[1]);
          }
        }
      }
    }
  }
}

template <typename T, int kWin, int kTH, int kTW, int kNT, int kCtas>
__global__ void __launch_bounds__(kNT, kCtas) pixel_unroll_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  // phase<kind, window, T, x's type, o's type, tile, threads>(a, x, rhs, prev, o, u, alpha,
  // beta)
  phase<kRhs, kWin, T, T, float, kTH, kTW, kNT>(a, a.y, nullptr, nullptr, a.P0, nullptr, -1,
                                                 -1, smem);
  grid.sync();
  phase<kCgFirst, kWin, T, float, float, kTH, kTW, kNT>(a, a.P0, nullptr, nullptr, a.P1, a.P2,
                                                         3, -1, smem);
  grid.sync();
  phase<kCgNext, kWin, T, float, float, kTH, kTW, kNT>(a, a.P1, a.P0, a.P2, a.P0, nullptr, 4, 7,
                                                        smem);  // beta[1]; beta[0] unused
  grid.sync();
  phase<kRethresh, kWin, T, float, float, kTH, kTW, kNT>(a, a.P0, nullptr, nullptr, a.P1,
                                                          nullptr, -1, -1, smem);
  grid.sync();
  phase<kCgFirst, kWin, T, float, float, kTH, kTW, kNT>(a, a.P1, nullptr, nullptr, a.P0, a.P2,
                                                         5, -1, smem);  // round 2 from rhs2
  grid.sync();
  phase<kCgNext, kWin, T, float, T, kTH, kTW, kNT>(a, a.P0, a.P1, a.P2, a.out, nullptr, 6, 8,
                                                    smem);  // beta[3]; beta[2] unused
}

template <typename T, int kWin>
constexpr size_t smem_bytes() {
  constexpr Tile p = tile_of<T>();
  return Layout<T, kWin, p.th, p.tw>::kBytes;
}

template <typename T, int kWin>
auto kernel_of() {
  constexpr Tile p = tile_of<T>();
  return &pixel_unroll_kernel<T, kWin, p.th, p.tw, p.threads, p.ctas>;
}

// The CTAs of the type's kernel that fit on one SM and the device's SM
// count, found once per device (after raising the kernel's shared memory
// limit); a CUDA error status on failure.
template <typename T, int kWin>
cudaError_t occupancy(int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static int cached_per_sm[kDevices], cached_sms[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached_per_sm[dev] > 0) {
    *per_sm = cached_per_sm[dev];
    *sms = cached_sms[dev];
    return cudaSuccess;
  }
  constexpr size_t smem = smem_bytes<T, kWin>();
  auto kern = kernel_of<T, kWin>();
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, tile_of<T>().threads,
                                                        smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) {
    cached_per_sm[dev] = *per_sm;
    cached_sms[dev] = *sms;
  }
  return err;
}

// A refused cooperative launch (too many CTAs to be co-resident) returns its
// error; nothing falls back.
template <typename T, int kWin>
int launch(const Args<T>& a, cudaStream_t stream) {
  constexpr Tile p = tile_of<T>();
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy<T, kWin>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long tiles = (long long)((a.W + p.tw - 1) / p.tw) * ((a.H + p.th - 1) / p.th);
  const long long items = (long long)a.B * a.G * tiles;
  if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long long>(items, (long long)per_sm * sms));
  Args<T> args = a;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of<T, kWin>()), dim3(grid), dim3(p.threads), params,
      smem_bytes<T, kWin>(), stream));
}

template <typename T, int kWin>
int ctas_per_sm() {
  int per_sm = -1, sms = 0;
  return occupancy<T, kWin>(&per_sm, &sms) == cudaSuccess ? per_sm : -1;
}

// One launch's operands as the C interface takes them.
struct Call {
  const void *y, *wgtv, *wglr, *pgtv, *pglr, *scal;
  void *out, *scratch;
  int B, G, F, H, W, dtype;
  cudaStream_t stream;
};

template <typename T, int kWin>
int launch_call(const Call& c) {
  float* scr = static_cast<float*>(c.scratch);
  const size_t n = (size_t)c.B * c.G * c.F * c.H * c.W;
  const Args<T> a{static_cast<const T*>(c.y), static_cast<const T*>(c.wgtv),
                  static_cast<const T*>(c.wglr), static_cast<const float*>(c.pgtv),
                  static_cast<const float*>(c.pglr), static_cast<const float*>(c.scal),
                  static_cast<T*>(c.out), scr, scr + n, scr + 2 * n, c.B, c.G, c.F, c.H, c.W};
  return launch<T, kWin>(a, c.stream);
}

// One window's entry points. Each window's instances are compiled in a
// translation unit of their own (pixel_unroll.cu for diamond-12, pixel_unroll_cross4.cu,
// pixel_unroll_ring8.cu), so that nvcc builds the windows side by side; pixel_unroll.cu's
// C interface picks one.
struct Entry {
  int (*run)(const Call& c);
  long long (*smem)(int dtype);
  int (*ctas_per_sm)(int dtype);
};

template <int kWin>
int run_window(const Call& c) {
  if (c.dtype == kFloat32) return launch_call<float, kWin>(c);
  if (c.dtype == kBFloat16) return launch_call<__nv_bfloat16, kWin>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kWin>
long long smem_window(int dtype) {
  if (dtype == kBFloat16) return static_cast<long long>(smem_bytes<__nv_bfloat16, kWin>());
  if (dtype == kFloat32) return static_cast<long long>(smem_bytes<float, kWin>());
  return -1;
}

template <int kWin>
int ctas_window(int dtype) {
  if (dtype == kFloat32) return ctas_per_sm<float, kWin>();
  if (dtype == kBFloat16) return ctas_per_sm<__nv_bfloat16, kWin>();
  return -1;
}

template <int kWin>
constexpr Entry entry_of() {
  return Entry{&run_window<kWin>, &smem_window<kWin>, &ctas_window<kWin>};
}

extern const Entry kCross4Entry, kDiamond12Entry, kRing8Entry;

}  // namespace pix
}  // namespace irdu

