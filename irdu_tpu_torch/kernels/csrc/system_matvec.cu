// K9: the single-scale system matvec x + mu (.) GLR(x) + rho (.) GTV(x),
// cross-4 window, channels-last. Replaces
// irdu_tpu/ops/pallas/solver_matvec.py:fused_system_matvec (_kernel). The
// math, the layouts and the bound are set out in
// irdu_tpu_torch/ops/system_matvec.py; the padded tile's boundary rules in
// padded_tile.cuh.
//
// x and out are (B, H, W, C) with C = G*F, channel c of graph c / F; the edge
// weights are (B, H, W, G, 4), edge order (-1,0), (0,-1), (0,1), (1,0); the
// stencil rows (4, C) and mu, rho (C,) are f32. A CTA takes one kTH x kTW
// output tile of one image and walks its channels in chunks of kN lanes,
// graph by graph (a chunk never straddles two graphs; the last chunk of a
// graph may be partial):
//   - the graph's 4 GLR and 4 GTV weights of the tile come into shared
//     memory once, as [cell][edge], and serve all its chunks (at G = 1 all
//     C channels); the next graph's are staged while a chunk's epilogue runs;
//   - chunk j + 1's x box (kN lanes a cell: one 16-byte cp.async in bf16)
//     comes into the second of two buffers while chunk j computes, and stays
//     there for the epilogue; its per-lane stencil rows, mu and rho go to a
//     small table beside it;
//   - stage planes are f32 [cell][lane] over boxes not clipped to the image,
//     each thread working on one quad (4 lanes) of a cell: S (both
//     stencils, at the pixel clamped to the image, so a derived array
//     replicates its own edge) on the tile + 2, A (the edge sums, zero
//     outside the image) on the tile + 1, x (the replicate pad) on the
//     tile + 3;
//   - the epilogue stores 16 bytes a pixel in bf16: the two quads of a cell
//     sit in neighbouring threads, which pair their halves by a shuffle.
// Boundaries (irdu_tpu/ops/pallas/solver_matvec.py:19-23): the stencil's
// input x replicates its edge; a shift of a derived plane replicates that
// plane's own edge; the C^T scatter and the transposed stencil read zeros.

#include "padded_tile.cuh"

namespace irdu {
namespace matvec {

using namespace irdu::ptile;

// The tile, as ops/system_matvec.py's K9_TILE: {rows, columns, lanes,
// threads, CTAs an SM}; 16x16 tiles of 8 lanes, the fastest of 8x32, 16x32
// and 16x16 on the card (PERF.md, K9's design note).
struct Tile {
  int th, tw, lanes, threads, ctas;
};
constexpr Tile kTile = {16, 16, 8, 256, 2};
constexpr int kCoefs = 10;  // per lane: GTV stencil p0-p3, GLR stencil p0-p3, mu, rho

// Halos: S and the weights on the tile + 2, x on the tile + 3.
template <int kTH, int kTW>
struct Geo {
  static constexpr int HS = 2, HX = 3;
  static constexpr int PH = kTH + 2 * HS, PW = kTW + 2 * HS, NP = PH * PW;
  static constexpr int XH = kTH + 2 * HX, XW = kTW + 2 * HX, NX = XH * XW;
};

// Shared memory (bytes, each part 16-aligned): f32 planes Sg, Ag, Sl, Al of
// kN lanes a cell; two x boxes of kN lanes a cell; the weights [cell][edge]
// gtv, glr; two coefficient tables [coef][lane].
template <typename T, int kTH, int kTW, int kN>
struct Layout {
  using G = Geo<kTH, kTW>;
  static constexpr size_t kPlanes = up16(sizeof(float) * 4 * G::NP * kN);
  static constexpr size_t kX = up16(sizeof(T) * G::NX * kN);
  static constexpr size_t kW = up16(sizeof(T) * 2 * 4 * G::NP);
  static constexpr size_t kC = up16(sizeof(float) * kCoefs * kN);
  static constexpr size_t kBytes = kPlanes + 2 * kX + kW + 2 * kC;
};

struct Args {
  const void *x, *wl, *wg;  // x (B, H, W, C); the GLR and GTV weights (B, H, W, G, 4)
  const float *pl, *pg;     // (4, C) stencil rows p01, p02a, p02b, p03
  const float *mu, *ro;     // (C,)
  void* out;
  int H, W, C, F, G, tiles_w;
};

// kN lanes from global to shared memory by 16-byte cp.async (or one of 4 or
// 8 bytes where the lanes make less).
template <int kN, typename T>
__device__ __forceinline__ void copy_cell(T* dst, const T* src) {
  constexpr int kB = kN * static_cast<int>(sizeof(T));
  if constexpr (kB > 16) {
    static_assert(kB % 16 == 0, "whole 16-byte chunks");
#pragma unroll
    for (int k = 0; k < kB / 16; ++k) {
      constexpr int kStep = 16 / static_cast<int>(sizeof(T));
      cp_async<16>(dst + k * kStep, src + k * kStep);
    }
  } else {
    copy_lanes<kN>(dst, src);
  }
}

// A quad (4 lanes) of T at p as f32.
__device__ __forceinline__ void ld_quad(const float* p, float (&v)[4]) { ld_lanes<4>(p, v); }
__device__ __forceinline__ void ld_quad(const __nv_bfloat16* p, float (&v)[4]) {
  ld_lanes<4>(p, v);
}

// Lane n of a quad (n a constant once unrolled).
__device__ __forceinline__ float lane(const float4& v, int n) {
  return n == 0 ? v.x : (n == 1 ? v.y : (n == 2 ? v.z : v.w));
}

// stats (kT = false) or stats^T (kT = true) of 4 lanes from the centre and
// its right, down, up and left neighbours, per-lane coefficients p[k].
template <bool kT>
__device__ __forceinline__ void stencil4(const float4 (&p)[4], const float (&v)[4],
                                         const float (&r)[4], const float (&d)[4],
                                         const float (&u)[4], const float (&l)[4],
                                         float (&o)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float s = 4.f * v[n] - u[n] - d[n] - l[n] - r[n];
    const float p0 = lane(p[0], n), p1 = lane(p[1], n), p2 = lane(p[2], n), p3 = lane(p[3], n);
    o[n] = kT ? p0 * v[n] + p1 * (l[n] - v[n]) + p2 * (u[n] - v[n]) + p3 * s
              : p0 * v[n] + p1 * (r[n] - v[n]) + p2 * (d[n] - v[n]) + p3 * s;
  }
}

// The 4 coefficient quads k0 .. k0 + 3 of quad q from a [coef][lane] table.
template <int kN>
__device__ __forceinline__ void coef_quads(const float* tab, int k0, int q, float4 (&p)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = *reinterpret_cast<const float4*>(tab + (k0 + k) * kN + 4 * q);
}

// kVec: F is a multiple of kN (every chunk whole, its lanes aligned).
template <typename T, int kTH, int kTW, int kN, int kNT, int kCtas, bool kVec>
__global__ void __launch_bounds__(kNT, kCtas) system_matvec_kernel(const Args a) {
  using G = Geo<kTH, kTW>;
  using L = Layout<T, kTH, kTW, kN>;
  constexpr int QN = kN / 4;  // quads a cell
  static_assert(kN % 4 == 0 && kNT % (2 * QN) == 0, "a thread keeps one quad of every cell");
  extern __shared__ __align__(16) unsigned char smem[];
  float* Sg = reinterpret_cast<float*>(smem);
  float* Ag = Sg + G::NP * kN;
  float* Sl = Ag + G::NP * kN;
  float* Al = Sl + G::NP * kN;
  unsigned char* xbox = smem + L::kPlanes;  // two buffers of L::kX bytes
  T* Wg = reinterpret_cast<T*>(smem + L::kPlanes + 2 * L::kX);  // [cell][edge]
  T* Wl = Wg + 4 * G::NP;
  float* coef = reinterpret_cast<float*>(smem + L::kPlanes + 2 * L::kX + L::kW);  // 2 tables

  const int H = a.H, W = a.W, C = a.C, F = a.F, Gn = a.G;
  const int ty = blockIdx.x / a.tiles_w, tx = blockIdx.x - ty * a.tiles_w;
  const int ti0 = ty * kTH, tj0 = tx * kTW;
  const int oi = ti0 - G::HS, oj = tj0 - G::HS, xi0 = ti0 - G::HX, xj0 = tj0 - G::HX;
  const size_t pix0 = (size_t)blockIdx.y * H * W;
  const T* x = static_cast<const T*>(a.x);
  const int per_graph = (F + kN - 1) / kN, chunks = Gn * per_graph;
  const int q = threadIdx.x % QN;  // this thread's quad in every stage

  // graph g's weights of the tile, [cell][edge], zero outside the image
  auto stage_weights = [&](int g) {
    const T* wg = static_cast<const T*>(a.wg) + g * 4;
    const T* wl = static_cast<const T*>(a.wl) + g * 4;
    for_box<kNT, 2 * G::PH, G::PW>([&](int hr, int c) {
      const int op = hr >= G::PH, r = hr - op * G::PH;
      const int gi = oi + r, gj = oj + c;
      T* d = (op ? Wl : Wg) + (r * G::PW + c) * 4;
      if (gi < 0 || gi >= H || gj < 0 || gj >= W) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = zero<T>();
      } else {
        copy_lanes<4>(d, (op ? wl : wg) + (pix0 + (size_t)gi * W + gj) * 4 * Gn);
      }
    });
  };
  // chunk j's channels: graph j / per_graph, first channel c0, cn lanes valid
  auto chunk_of = [&](int j, int& g, int& c0, int& cn) {
    g = j / per_graph;
    const int k = j - g * per_graph;
    c0 = g * F + k * kN;
    cn = min(kN, F - k * kN);
  };
  // chunk j's x box (the replicate pad) and its coefficient table
  auto stage_chunk = [&](int j, int buf) {
    int g, c0, cn;
    chunk_of(j, g, c0, cn);
    T* dst = reinterpret_cast<T*>(xbox + buf * L::kX);
    for_box<kNT, G::XH, G::XW>([&](int r, int c) {
      const int gi = clampi(xi0 + r, H), gj = clampi(xj0 + c, W);
      const T* s = x + (pix0 + (size_t)gi * W + gj) * C + c0;
      T* d = dst + (r * G::XW + c) * kN;
      if (kVec) {
        copy_cell<kN>(d, s);
      } else {
#pragma unroll
        for (int n = 0; n < kN; ++n) d[n] = n < cn ? s[n] : zero<T>();
      }
    });
    float* tab = coef + buf * (L::kC / sizeof(float));
    for (int k = threadIdx.x; k < kCoefs * kN; k += kNT) {
      const int row = k / kN, ch = c0 + min(k - row * kN, cn - 1);
      tab[k] = row < 4 ? a.pg[row * C + ch]
                       : (row < 8 ? a.pl[(row - 4) * C + ch] : (row == 8 ? a.mu[ch] : a.ro[ch]));
    }
  };

  stage_weights(0);
  stage_chunk(0, 0);
  cp_async_commit();
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait_all();
    __syncthreads();  // chunk j's box, table (and weights) landed; chunk j - 1 is done
    const T* X = reinterpret_cast<const T*>(xbox + (j & 1) * L::kX);
    const float* tab = coef + (j & 1) * (L::kC / sizeof(float));
    if (j + 1 < chunks) {
      stage_chunk(j + 1, (j + 1) & 1);
      cp_async_commit();
    }
    // 2. both stencils over the tile + 2, at the pixel clamped to the image
    {
      float4 pg[4], pl[4];
      coef_quads<kN>(tab, 0, q, pg);
      coef_quads<kN>(tab, 4, q, pl);
      for_box<kNT, G::PH, G::PW * QN>([&](int r, int cq) {
        const int c = cq / QN;
        const int ci = clampi(oi + r, H), cj = clampi(oj + c, W);
        const int xc = ((ci - xi0) * G::XW + (cj - xj0)) * kN + 4 * q;
        float v[4], rr[4], d[4], u[4], l[4], o[4];
        ld_quad(X + xc, v);
        ld_quad(X + xc + kN, rr);
        ld_quad(X + xc + G::XW * kN, d);
        ld_quad(X + xc - G::XW * kN, u);
        ld_quad(X + xc - kN, l);
        const int pc = (r * G::PW + c) * kN + 4 * q;
        stencil4<false>(pg, v, rr, d, u, l, o);
        st_lanes<4>(Sg + pc, o);
        stencil4<false>(pl, v, rr, d, u, l, o);
        st_lanes<4>(Sl + pc, o);
      });
    }
    __syncthreads();
    // 3. the edge sums over the tile + 1, zero outside the image:
    //    Ag = sum_e w_e(p)^2 (Sg(p) - Sg(p + d_e)) - w_e(p - d_e)^2 (Sg(p - d_e) - Sg(p)),
    //    Al = Sl(p) - sum_e w_e(p) Sl(p + d_e)
    for_box<kNT, kTH + 2, (kTW + 2) * QN>([&](int r, int cq) {
      const int c = cq / QN;
      const int cell = (r + G::HS - 1) * G::PW + c + G::HS - 1;
      const int pc = cell * kN + 4 * q;
      const int gi = ti0 - 1 + r, gj = tj0 - 1 + c;
      float ag[4], al[4];
      if (gi < 0 || gi >= H || gj < 0 || gj >= W) {
#pragma unroll
        for (int n = 0; n < 4; ++n) ag[n] = al[n] = 0.f;
      } else {
        float sp[4], s0[4], wp[4], wl[4];
        ld_quad(Sg + pc, sp);
        ld_quad(Sl + pc, s0);
        ld_lanes<4>(Wg + cell * 4, wp);
        ld_lanes<4>(Wl + cell * 4, wl);
#pragma unroll
        for (int n = 0; n < 4; ++n) ag[n] = 0.f, al[n] = s0[n];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = dh_of(e) * G::PW + dw_of(e);
          const float wq = ld(Wg[(cell - off) * 4 + e]);
          float sn[4], sq[4], ln[4];
          ld_quad(Sg + pc + off * kN, sn);
          ld_quad(Sg + pc - off * kN, sq);
          ld_quad(Sl + pc + off * kN, ln);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            ag[n] += wp[e] * wp[e] * (sp[n] - sn[n]) - wq * wq * (sq[n] - sp[n]);
            al[n] -= wl[e] * ln[n];
          }
        }
      }
      st_lanes<4>(Ag + pc, ag);
      st_lanes<4>(Al + pc, al);
    });
    __syncthreads();
    int g, c0, cn;
    chunk_of(j, g, c0, cn);
    if (j + 1 < chunks && (j + 1) / per_graph != g) {  // the next graph's weights
      stage_weights(g + 1);
      cp_async_commit();
    }
    // 4. the tile: x + rho stats^T(Ag) + mu stats^T(Al), a quad a thread; every
    //    thread runs every round (the quads of a cell pair up by a shuffle)
    {
      float4 pg[4], pl[4];
      coef_quads<kN>(tab, 0, q, pg);
      coef_quads<kN>(tab, 4, q, pl);
      const float4 mu = *reinterpret_cast<const float4*>(tab + 8 * kN + 4 * q);
      const float4 ro = *reinterpret_cast<const float4*>(tab + 9 * kN + 4 * q);
      constexpr int kItems = kTH * kTW * QN, kPer = (kItems + kNT - 1) / kNT;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int it = threadIdx.x + k * kNT, p = it / QN;
        const int r = p / kTW, c = p - r * kTW, gi = ti0 + r, gj = tj0 + c;
        const bool live = it < kItems && gi < H && gj < W;
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        if (live) {
          const int pc = ((r + G::HS) * G::PW + c + G::HS) * kN + 4 * q;
          float v[4], rr[4], d[4], u[4], l[4], tg[4], tl[4], xv[4];
          ld_quad(Ag + pc, v);
          ld_quad(Ag + pc + kN, rr);
          ld_quad(Ag + pc + G::PW * kN, d);
          ld_quad(Ag + pc - G::PW * kN, u);
          ld_quad(Ag + pc - kN, l);
          stencil4<true>(pg, v, rr, d, u, l, tg);
          ld_quad(Al + pc, v);
          ld_quad(Al + pc + kN, rr);
          ld_quad(Al + pc + G::PW * kN, d);
          ld_quad(Al + pc - G::PW * kN, u);
          ld_quad(Al + pc - kN, l);
          stencil4<true>(pl, v, rr, d, u, l, tl);
          ld_quad(X + ((r + G::HX) * G::XW + c + G::HX) * kN + 4 * q, xv);
#pragma unroll
          for (int n = 0; n < 4; ++n) o[n] = xv[n] + lane(ro, n) * tg[n] + lane(mu, n) * tl[n];
        }
        T* dst = static_cast<T*>(a.out) + (pix0 + (size_t)gi * W + gj) * C + c0;
        if constexpr (kVec && sizeof(T) == 2 && QN == 2) {
          // quad 0 takes quad 1's four bf16 and stores the cell's 16 bytes
          __nv_bfloat162 h[2] = {__floats2bfloat162_rn(o[0], o[1]),
                                 __floats2bfloat162_rn(o[2], o[3])};
          unsigned w0 = *reinterpret_cast<unsigned*>(&h[0]);
          unsigned w1 = *reinterpret_cast<unsigned*>(&h[1]);
          const unsigned v0 = __shfl_xor_sync(0xffffffffu, w0, 1);
          const unsigned v1 = __shfl_xor_sync(0xffffffffu, w1, 1);
          if (live && q == 0) *reinterpret_cast<uint4*>(dst) = make_uint4(w0, w1, v0, v1);
        } else if constexpr (kVec) {
          if (live) st_lanes<4>(dst + 4 * q, o);
        } else if (live) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (4 * q + n < cn) st(dst + 4 * q + n, o[n]);
        }
      }
    }
  }
}

template <typename T, bool kVec>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr Tile p = kTile;
  constexpr size_t smem = Layout<T, p.th, p.tw, p.lanes>::kBytes;
  auto kern = system_matvec_kernel<T, p.th, p.tw, p.lanes, p.threads, p.ctas, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args b = a;
  b.tiles_w = (a.W + p.tw - 1) / p.tw;
  const long long tiles = (long long)b.tiles_w * ((a.H + p.th - 1) / p.th);
  if (tiles > 2147483647LL || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(static_cast<unsigned>(tiles), B), p.threads, smem, stream>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// Whole chunks (F a multiple of the lanes) vectorised.
template <typename T>
int dispatch(const Args& a, int B, cudaStream_t s) {
  return a.F % kTile.lanes == 0 ? launch<T, true>(a, B, s) : launch<T, false>(a, B, s);
}

template <typename T>
constexpr long long tile_bytes() {
  return static_cast<long long>(Layout<T, kTile.th, kTile.tw, kTile.lanes>::kBytes);
}

}  // namespace matvec
}  // namespace irdu

// x, out (B, H, W, C) and wl, wg (B, H, W, G, 4) in one dtype; pl, pg (4, C)
// and mu, ro (C,) f32; C = G * F.
extern "C" int irdu_system_matvec(const void* x, const void* wl, const void* wg,
                                  const void* pl, const void* pg, const void* mu,
                                  const void* ro, void* out, int B, int H, int W, int C,
                                  int G, int dtype, void* stream) {
  using namespace irdu::matvec;
  const bool bad = B < 1 || H < 1 || W < 1 || C < 1 || G < 1 || C % G || x == nullptr ||
                   wl == nullptr || wg == nullptr || pl == nullptr || pg == nullptr ||
                   mu == nullptr || ro == nullptr || out == nullptr;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, wl, wg, static_cast<const float*>(pl), static_cast<const float*>(pg),
               static_cast<const float*>(mu), static_cast<const float*>(ro), out,
               H, W, C, C / G, G, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == irdu::kFloat32) return dispatch<float>(a, B, s);
  if (dtype == irdu::kBFloat16) return dispatch<__nv_bfloat16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory one CTA takes in dtype (ops/system_matvec.py
// k9_smem_bytes holds its planner to it), or -1 for another dtype.
extern "C" long long irdu_system_matvec_smem(int dtype) {
  using namespace irdu::matvec;
  if (dtype == irdu::kFloat32) return tile_bytes<float>();
  if (dtype == irdu::kBFloat16) return tile_bytes<__nv_bfloat16>();
  return -1;
}
