// K5's kernel (see fused_step_hopper.cu): the templates, and the entry
// points of one window, instantiated in fused_step_hopper.cu (diamond-12),
// fused_step_cross4.cu and fused_step_ring8.cu.
#pragma once

#include "padded_tile.cuh"

namespace irdu {
namespace step5 {

using namespace irdu::ptile;

constexpr int kEpiAddX = 0, kEpiAddAux = 1, kEpiCg = 2;  // as in ops/fused_step.py

// The tile of a step, as ops/fused_step.py's k5_tile: {rows, columns,
// threads}. Two scales on ring-8 and diamond-12 take smaller tiles (their
// weights of both scales would outgrow a CTA's shared memory in f32 at
// 32x64). Each fits a CTA in f32 and in bf16.
struct Tile {
  int th, tw, threads;
};
constexpr Tile tile_at(int win, bool two_scale) {
  if (!two_scale) return {16, 64, 256};
  if (win == kRing8) return {16, 64, 256};
  if (win == kDiamond12) return {16, 32, 256};
  return {32, 64, 256};
}

// The boxes of a tile: planes with halo HS rows and HSC (even) columns, the
// x box with halo HXR rows and 8 columns (so that its rows start on 16-byte
// chunks of the image's rows); half-res planes (two scales) with the same
// halos. The half-res stencils cover the half tile + HS, whose box means
// read full-res columns down to 2 * (HS + 1) = 8 (radius 2) past the tile,
// inside the x box's 8.
template <int kWin, bool kTwo, int kTH, int kTW>
struct Geo {
  static_assert(!kTwo || 2 * (2 + Win<kWin>::R) <= 8, "half-res box means inside the x box");
  static_assert(kTH % 2 == 0 && kTW % 4 == 0, "tiles start on even pixels, half tiles too");
  static constexpr int R = Win<kWin>::R;
  static constexpr int HS = 1 + R, HSC = (HS + 1) & ~1;
  static constexpr int PH = kTH + 2 * HS, PW = kTW + 2 * HSC, NP = PH * PW;
  static constexpr int HXR = kTwo ? 2 * (2 + R) : 2 + R;
  static constexpr int HXC = 8;
  static constexpr int XH = kTH + 2 * HXR, XW = kTW + 2 * HXC, NX = XH * XW;
  static constexpr int PH1 = kTH / 2 + 2 * HS, PW1 = kTW / 2 + 2 * HSC;
  static constexpr int NP1 = kTwo ? PH1 * PW1 : 0;
};

// Shared memory (bytes, each part 16-aligned): f32 planes Sg, Ag[, Sl, Al],
// the same at half res, two x boxes, the weights [e][cell] gtv[, glr], the
// same at half res.
template <typename T, int kWin, bool kGlr, bool kTwo, int kTH, int kTW>
struct Layout {
  using G = Geo<kWin, kTwo, kTH, kTW>;
  static constexpr int NA = kGlr ? 2 : 1, E = Win<kWin>::E;
  static constexpr size_t kPlanes = up16(sizeof(float) * 2 * NA * G::NP);
  static constexpr size_t kPlanes1 = up16(sizeof(float) * 2 * NA * G::NP1);
  static constexpr size_t kX = up16(sizeof(T) * G::NX);
  static constexpr size_t kW = up16(sizeof(T) * NA * E * G::NP);
  static constexpr size_t kW1 = up16(sizeof(T) * NA * E * G::NP1);
  static constexpr size_t kBytes = kPlanes + kPlanes1 + 2 * kX + kW + kW1;
};

struct Args {
  const void *x, *aux, *prev;
  const void *wg0, *wl0, *wg1, *wl1;  // (B, G, E, H, W) / (B, G, E, H/2, W/2)
  const float *pg0, *pl0, *pg1, *pl1;  // (G, 4, F) stats tables
  const float* scal;                   // (G, 8): mu0, rho0, mu1, rho1, alpha, beta, gamma0, gamma1
  void *out, *upd;
  int G, F, H, W, epi, use_x_rhs, reflect, tiles_w;
};

// kPlanes planes of kRows x kCols cells from planes of an H x W image
// (plane stride n) at origin (r0, c0), zero outside the image. Pairs of
// cells in the image come by cp.async (c0 and W even).
template <typename T, int kPlanes, int kRows, int kCols, int kNT>
__device__ __forceinline__ void stage_zero_padded(T* dst, const T* src, size_t n, int r0, int c0,
                                                  int H, int W) {
  const bool vec = (W & 1) == 0;
  for_box<kNT, kPlanes * kRows, kCols / 2>([&](int pr, int cp) {
    const int e = pr / kRows, r = pr - e * kRows;
    const int gi = r0 + r, gj = c0 + 2 * cp;
    T* d = dst + pr * kCols + 2 * cp;
    const bool row_in = gi >= 0 && gi < H;
    const T* s = src + e * n + (size_t)(row_in ? gi : 0) * W;
    if (vec && row_in && gj >= 0 && gj + 1 < W) {
      copy_lanes<2>(d, s + gj);
      return;
    }
    d[0] = row_in && gj >= 0 && gj < W ? s[gj] : zero<T>();
    d[1] = row_in && gj + 1 >= 0 && gj + 1 < W ? s[gj + 1] : zero<T>();
  });
}

// A kRows x kCols box of one H x W plane at origin (r0, c0), each cell the
// pixel its pad reads (pad_index); chunks of 8 cells inside the image by
// 16-byte cp.async (c0, kCols and W multiples of 8).
template <typename T, int kRows, int kCols, int kNT>
__device__ __forceinline__ void stage_padded(T* dst, const T* src, int r0, int c0, int H, int W,
                                             bool reflect) {
  constexpr int kChunk = 8, kPer16 = 16 / sizeof(T);
  static_assert(kCols % kChunk == 0, "whole chunks a row");
  const bool vec = W % kChunk == 0;
  for_box<kNT, kRows, kCols / kChunk>([&](int r, int ck) {
    const T* row = src + (size_t)pad_index(r0 + r, H, reflect) * W;
    const int gj = c0 + kChunk * ck;
    T* d = dst + r * kCols + kChunk * ck;
    if (vec && gj >= 0 && gj + kChunk <= W) {
#pragma unroll
      for (int k = 0; k < kChunk; k += kPer16) cp_async<16>(d + k, row + gj + k);
      return;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) d[k] = row[pad_index(gj + k, W, reflect)];
  });
}

// The epilogue on n (1 or 2) adjacent pixels of a row at plane offset idx:
// two-element stores where both lie in the image and idx is even. Its reads
// (aux, prev) are issued when the plane's iteration starts and used only
// here, so that they arrive while the stencils and edge sums run.
template <typename T>
struct Pair {
  const Args& a;
  size_t idx;
  int n;
  __device__ __forceinline__ bool vec() const { return n == 2 && (idx & 1) == 0; }
  __device__ __forceinline__ bool reads_aux() const {
    return a.aux != nullptr && (a.epi == kEpiAddAux || (a.epi == kEpiCg && !a.use_x_rhs));
  }
  __device__ __forceinline__ void store(void* base, const float (&v)[2]) const {
    T* p = static_cast<T*>(base) + idx;
    if (vec()) {
      st_lanes<2>(p, v);
    } else {
      st(p, v[0]);
      if (n == 2) st(p + 1, v[1]);
    }
  }
  // aux and prev as loaded, element by element from pointers chosen before
  // the loads (x stands in for a plane the epilogue does not read), so that
  // no value is merged or converted until the epilogue uses it
  __device__ __forceinline__ void inputs(Raw<2, T>& aux, Raw<2, T>& prev) const {
    const T* pa = static_cast<const T*>(reads_aux() ? a.aux : a.x) + idx;
    const T* pp = static_cast<const T*>(a.prev != nullptr ? a.prev : a.x) + idx;
    aux.v[0] = pa[0];
    aux.v[1] = pa[n - 1];
    prev.v[0] = pp[0];
    prev.v[1] = pp[n - 1];
  }
  __device__ __forceinline__ void outputs(const float (&t)[2], const float (&xv)[2],
                                          const Raw<2, T>& aux_raw, const Raw<2, T>& prev_raw,
                                          float alpha, float beta) const {
    float o[2], u[2], aux[2] = {0.f, 0.f}, prev[2] = {0.f, 0.f};
    if (reads_aux()) aux_raw.get(aux);
    if (a.epi == kEpiCg && a.prev != nullptr) prev_raw.get(prev);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (a.epi == kEpiAddX) {
        o[k] = xv[k] + t[k];
      } else if (a.epi == kEpiAddAux) {
        o[k] = t[k] + aux[k];  // aux is 0 without y
      } else {  // CG: upd = rhs - A x [+ beta prev], out = x + alpha upd
        u[k] = (a.use_x_rhs ? xv[k] : aux[k]) - (xv[k] + t[k]);
        if (a.prev != nullptr) u[k] += beta * prev[k];
        o[k] = fmaf(alpha, u[k], xv[k]);
      }
    }
    if (a.epi == kEpiCg && a.upd != nullptr) store(a.upd, u);
    store(a.out, o);
  }
};

template <typename T, int kWin, bool kRe, bool kGlr, bool kTwo, int kTH, int kTW, int kNT>
__global__ void __launch_bounds__(kNT) step_kernel(const Args a) {
  using G = Geo<kWin, kTwo, kTH, kTW>;
  using L = Layout<T, kWin, kGlr, kTwo, kTH, kTW>;
  constexpr int E = Win<kWin>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Sg = reinterpret_cast<float*>(smem);
  float* Ag = Sg + G::NP;
  float* Sl = Ag + G::NP;  // GLR only
  float* Al = Sl + G::NP;
  float* Sg1 = reinterpret_cast<float*>(smem + L::kPlanes);  // two-scale only
  float* Ag1 = Sg1 + G::NP1;
  float* Sl1 = Ag1 + G::NP1;
  float* Al1 = Sl1 + G::NP1;
  unsigned char* xbox = smem + L::kPlanes + L::kPlanes1;  // two buffers of L::kX bytes
  T* Wg = reinterpret_cast<T*>(smem + L::kPlanes + L::kPlanes1 + 2 * L::kX);
  T* Wl = Wg + E * G::NP;
  T* Wg1 = reinterpret_cast<T*>(smem + L::kPlanes + L::kPlanes1 + 2 * L::kX + L::kW);
  T* Wl1 = Wg1 + E * G::NP1;

  const int H = a.H, W = a.W, H2 = H / 2, W2 = W / 2, F = a.F;
  const int bg = blockIdx.y, g = bg % a.G;  // (b, g)
  const int ty = blockIdx.x / a.tiles_w, tx = blockIdx.x - ty * a.tiles_w;
  const int ti0 = ty * kTH, tj0 = tx * kTW, hi0 = ti0 / 2, hj0 = tj0 / 2;
  const int oi = ti0 - G::HS, oj = tj0 - G::HSC;       // plane cell (0, 0)
  const int oi1 = hi0 - G::HS, oj1 = hj0 - G::HSC;     // half plane cell (0, 0)
  const int xi0 = ti0 - G::HXR, xj0 = tj0 - G::HXC;    // x box cell (0, 0)
  const size_t n0 = (size_t)H * W, n1 = (size_t)H2 * W2;
  const bool reflect = a.reflect != 0;

  // the tile's weights, once for all F planes; plane 0's x box
  stage_zero_padded<T, E, G::PH, G::PW, kNT>(
      Wg, static_cast<const T*>(a.wg0) + (size_t)bg * E * n0, n0, oi, oj, H, W);
  if (kGlr)
    stage_zero_padded<T, E, G::PH, G::PW, kNT>(
        Wl, static_cast<const T*>(a.wl0) + (size_t)bg * E * n0, n0, oi, oj, H, W);
  if (kTwo) {
    stage_zero_padded<T, E, G::PH1, G::PW1, kNT>(
        Wg1, static_cast<const T*>(a.wg1) + (size_t)bg * E * n1, n1, oi1, oj1, H2, W2);
    if (kGlr)
      stage_zero_padded<T, E, G::PH1, G::PW1, kNT>(
          Wl1, static_cast<const T*>(a.wl1) + (size_t)bg * E * n1, n1, oi1, oj1, H2, W2);
  }
  const T* x = static_cast<const T*>(a.x) + (size_t)bg * F * n0;
  stage_padded<T, G::XH, G::XW, kNT>(reinterpret_cast<T*>(xbox), x, xi0, xj0, H, W, reflect);
  cp_async_commit();

  const float* sc = a.scal + g * 8;
  const float mu0 = sc[0], ro0 = sc[1], mu1 = sc[2], ro1 = sc[3];
  const float alpha = sc[4], beta = sc[5];
  const float gam0[1] = {sc[6]}, gam1[1] = {sc[7]};

  // plane f's stencil coefficients, loaded a plane ahead
  auto stats_of = [&](int f, Stats (&st)[4]) {
    st[0] = load_stats(a.pg0, g, F, f);
    st[1] = kGlr ? load_stats(a.pl0, g, F, f) : Stats{};
    st[2] = kTwo ? load_stats(a.pg1, g, F, f) : Stats{};
    st[3] = kTwo && kGlr ? load_stats(a.pl1, g, F, f) : Stats{};
  };
  Stats next[4];
  stats_of(0, next);

  for (int f = 0; f < F; ++f) {
    cp_async_wait_all();
    __syncthreads();  // plane f's x box (and the weights) landed; plane f - 1 is done
    const T* X = reinterpret_cast<const T*>(xbox + (f & 1) * L::kX);
    if (f + 1 < F) {
      stage_padded<T, G::XH, G::XW, kNT>(reinterpret_cast<T*>(xbox + ((f + 1) & 1) * L::kX),
                                         x + (f + 1) * n0, xi0, xj0, H, W, reflect);
      cp_async_commit();
    }
    // the epilogue's reads of this thread's 2x2 boxes, issued now so that
    // they arrive while the stencils and edge sums run
    const size_t base = ((size_t)bg * F + f) * n0;
    constexpr int kBW = kTW / 2, kBoxes = kTH / 2 * kBW, kPer = (kBoxes + kNT - 1) / kNT;
    Raw<2, T> aux[kPer][2], prev[kPer][2];  // [box][row]
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int box = threadIdx.x + k * kNT, bi = box / kBW, bj = box - bi * kBW;
      const int gi = ti0 + 2 * bi, gj = tj0 + 2 * bj;
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        if (box < kBoxes && gi + di < H && gj < W)
          Pair<T>{a, base + (size_t)(gi + di) * W + gj, gj + 1 < W ? 2 : 1}.inputs(
              aux[k][di], prev[k][di]);
      }
    }
    const Stats sg0 = next[0], sl0 = next[1], sg1 = next[2], sl1 = next[3];
    if (f + 1 < F) stats_of(f + 1, next);

    // 2. the stencils over the tile + HS, at the pixel clamped to the image
    constexpr int kSc = G::HSC - G::HS;  // the S box's first column
    for_box<kNT, G::PH, kTW + 2 * G::HS>([&](int r, int c) {
      const int ci = clampi(oi + r, H), cj = clampi(oj + c + kSc, W);
      stencil_cell<1, G::XW, kGlr>(X, (ci - xi0) * G::XW + (cj - xj0), sg0, sl0, Sg, Sl,
                                   r * G::PW + c + kSc);
    });
    if (kTwo) {  // the half-res stencils on the 2x2 box means, with their own pad
      for_box<kNT, G::PH1, kTW / 2 + 2 * G::HS>([&](int r, int c) {
        const int ci = clampi(oi1 + r, H2), cj = clampi(oj1 + c + kSc, W2);
        // x box rows of the half rows ci - 1, ci, ci + 1 and columns of the
        // half columns, each through XD's pad
        int xr[3], xc[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xr[k] = (2 * pad_index(ci - 1 + k, H2, reflect) - xi0) * G::XW;
          xc[k] = 2 * pad_index(cj - 1 + k, W2, reflect) - xj0;
        }
        auto box_mean = [&](int i, int j) {  // a 2x2 box: two pair loads (xc even)
          float u[2], v[2];
          ld_lanes<2>(X + xr[i] + xc[j], u);
          ld_lanes<2>(X + xr[i] + G::XW + xc[j], v);
          return 0.25f * (u[0] + u[1] + v[0] + v[1]);
        };
        const float xd[5] = {box_mean(1, 1), box_mean(1, 2), box_mean(2, 1), box_mean(0, 1),
                             box_mean(1, 0)};
        const int pc = r * G::PW1 + c + kSc;
        Sg1[pc] = stats5(sg1, xd[0], xd[1], xd[2], xd[3], xd[4]);
        if (kGlr) Sl1[pc] = stats5(sl1, xd[0], xd[1], xd[2], xd[3], xd[4]);
      });
    }
    __syncthreads();
    // 3. the edge sums over the tile + 1, zero outside the image
    for_box<kNT, kTH + 2, kTW + 2>([&](int r, int c) {
      const int pc = (r + G::HS - 1) * G::PW + c + G::HSC - 1;
      const int gi = ti0 - 1 + r, gj = tj0 - 1 + c;
      if (gi < 0 || gi >= H || gj < 0 || gj >= W)
        zero_cell<1, kGlr>(Ag, Al, pc);
      else
        edge_cell<1, kWin, kRe, kGlr, G::PW, G::NP>(Sg, Sl, Wg, Wl, pc, gam0, Ag, Al);
    });
    if (kTwo) {
      for_box<kNT, kTH / 2 + 2, kTW / 2 + 2>([&](int r, int c) {
        const int pc = (r + G::HS - 1) * G::PW1 + c + G::HSC - 1;
        const int gi = hi0 - 1 + r, gj = hj0 - 1 + c;
        if (gi < 0 || gi >= H2 || gj < 0 || gj >= W2)
          zero_cell<1, kGlr>(Ag1, Al1, pc);
        else
          edge_cell<1, kWin, kRe, kGlr, G::PW1, G::NP1>(Sg1, Sl1, Wg1, Wl1, pc, gam1, Ag1, Al1);
      });
    }
    __syncthreads();
    // 4. the tile, a 2x2 box a thread: T and the epilogue
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int box = threadIdx.x + k * kNT, bi = box / kBW, bj = box - bi * kBW;
      const int gi = ti0 + 2 * bi, gj = tj0 + 2 * bj;
      if (box >= kBoxes || gi >= H || gj >= W) continue;
      float t1 = 0.f;
      if (kTwo) {
        const int pc1 = (G::HS + bi) * G::PW1 + G::HSC + bj;
        float tg[1], tl[1];
        stats_t_cell<1, G::PW1>(Ag1, pc1, sg1, tg);
        t1 = ro1 * tg[0];
        if (kGlr) {
          stats_t_cell<1, G::PW1>(Al1, pc1, sl1, tl);
          t1 += mu1 * tl[0];
        }
      }
      const int n = gj + 1 < W ? 2 : 1;
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const int i = gi + di;
        if (i >= H) break;
        // the row's pixel pair (plane columns even): stats^T of both from
        // float2 reads of the plane (columns c - 2 .. c + 3 and rows i +- 1)
        const int pc = (G::HS + 2 * bi + di) * G::PW + G::HSC + 2 * bj;
        float t[2], tl[2], xv[2];
        stats_t_pair<G::PW>(Ag, pc, sg0, t);
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) t[dj] *= ro0;
        if (kGlr) {
          stats_t_pair<G::PW>(Al, pc, sl0, tl);
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) t[dj] += mu0 * tl[dj];
        }
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) if (kTwo) t[dj] += 0.25f * t1;
        ld_lanes<2>(X + (i - xi0) * G::XW + gj - xj0, xv);
        Pair<T>{a, base + (size_t)i * W + gj, n}.outputs(t, xv, aux[k][di], prev[k][di], alpha,
                                                         beta);
      }
    }
  }
}

template <typename T, int kWin, bool kRe, bool kGlr, bool kTwo, int kTH, int kTW, int kNT>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, kWin, kGlr, kTwo, kTH, kTW>::kBytes;
  auto kern = step_kernel<T, kWin, kRe, kGlr, kTwo, kTH, kTW, kNT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args b = a;
  b.tiles_w = (a.W + kTW - 1) / kTW;
  const dim3 grid(b.tiles_w * ((a.H + kTH - 1) / kTH), B * a.G);
  kern<<<grid, kNT, smem, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// The mode: the re-threshold, the system with GLR, or without.
template <typename T, int kWin, bool kTwo, int kTH, int kTW, int kNT>
int dispatch_mode(const Args& a, int B, bool rethresh, bool glr, cudaStream_t s) {
  if (rethresh) return launch<T, kWin, true, false, kTwo, kTH, kTW, kNT>(a, B, s);
  if (glr) return launch<T, kWin, false, true, kTwo, kTH, kTW, kNT>(a, B, s);
  return launch<T, kWin, false, false, kTwo, kTH, kTW, kNT>(a, B, s);
}

// The window's tile for the scale count (tile_at).
template <typename T, int kWin, bool kTwo>
int dispatch(const Args& a, int B, bool rethresh, bool glr, cudaStream_t s) {
  constexpr Tile t = tile_at(kWin, kTwo);
  return dispatch_mode<T, kWin, kTwo, t.th, t.tw, t.threads>(a, B, rethresh, glr, s);
}

template <typename T, int kWin, bool kTwo>
long long smem_of(bool glr) {
  constexpr Tile t = tile_at(kWin, kTwo);
  return static_cast<long long>(glr ? Layout<T, kWin, true, kTwo, t.th, t.tw>::kBytes
                                    : Layout<T, kWin, false, kTwo, t.th, t.tw>::kBytes);
}

// One window's entry points. Each window's instances are compiled in a
// translation unit of their own (fused_step_hopper.cu for diamond-12, fused_step_cross4.cu,
// fused_step_ring8.cu), so that nvcc builds the windows side by side; fused_step_hopper.cu's
// C interface picks one.
struct Entry {
  int (*run)(const Args& a, int B, bool two, bool rethresh, bool glr, int dtype, cudaStream_t s);
  long long (*smem)(bool two, bool glr, int dtype);
};

template <int kWin>
int run_window(const Args& a, int B, bool two, bool rethresh, bool glr, int dtype,
               cudaStream_t s) {
  if (dtype == kFloat32)
    return two ? dispatch<float, kWin, true>(a, B, rethresh, glr, s)
               : dispatch<float, kWin, false>(a, B, rethresh, glr, s);
  if (dtype == kBFloat16)
    return two ? dispatch<__nv_bfloat16, kWin, true>(a, B, rethresh, glr, s)
               : dispatch<__nv_bfloat16, kWin, false>(a, B, rethresh, glr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kWin>
long long smem_window(bool two, bool glr, int dtype) {
  if (dtype == kFloat32)
    return two ? smem_of<float, kWin, true>(glr) : smem_of<float, kWin, false>(glr);
  if (dtype == kBFloat16)
    return two ? smem_of<__nv_bfloat16, kWin, true>(glr)
               : smem_of<__nv_bfloat16, kWin, false>(glr);
  return -1;
}

template <int kWin>
constexpr Entry entry_of() {
  return Entry{&run_window<kWin>, &smem_window<kWin>};
}

extern const Entry kCross4Entry, kDiamond12Entry, kRing8Entry;

}  // namespace step5
}  // namespace irdu

