// The padded tile of K5 (fused_step_hopper.cu) and K8 (pixel_nhwc.cu): one
// unroll step of the GGTV+GGLR solvers on an output tile, its stage planes in
// shared memory over a box that is NOT clipped to the image. A cell outside
// the image holds what the reference's padding gives there, so every read of
// a stage plane is an unclamped constant offset:
//   x     the stencil's own pad: replicate ("edge") or reflect without the
//         edge (the pixel family), copied in from the mapped pixel;
//   S     the stencil output at the pixel clamped to the image: a derived
//         array replicates its own edge;
//   w     zero: the edge sum's second term w_e(p - d_e) vanishes where
//         p - d_e is outside the image;
//   A     zero: the C^T scatter and stats^T read zeros outside the image.
// Halos, from the window's radius r (Win<>::R: 1 cross-4 and ring-8, 2
// diamond-12): the tile's result reads A on the tile + 1; A reads S and w on
// the tile + 1 + r; S reads x on the tile + 2 + r. Cells of a plane are
// row-major, N channel lanes each (N = 1 for K5's CHW planes, the graph group
// for K8's channels-last ones).
// Index arithmetic walks each thread's cells incrementally (for_box): no
// division per element.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace irdu {
namespace ptile {

// The window codes the solver kernels take (ops/windows.py WINDOW_CODES).
constexpr int kCross4 = 0, kDiamond12 = 1, kRing8 = 2;

template <int kWin>
struct Win {
  static_assert(kWin == kCross4 || kWin == kDiamond12 || kWin == kRing8, "a window code");
  static constexpr int E = kWin == kCross4 ? 4 : (kWin == kRing8 ? kRingEdges : kDiamondEdges);
  static constexpr int R = kWin == kDiamond12 ? 2 : 1;
  __device__ __forceinline__ static int dh(int e) {
    return kWin == kCross4 ? dh_of(e) : (kWin == kRing8 ? r8_dh(e) : d12_dh(e));
  }
  __device__ __forceinline__ static int dw(int e) {
    return kWin == kCross4 ? dw_of(e) : (kWin == kRing8 ? r8_dw(e) : d12_dw(e));
  }
};

__host__ __device__ constexpr size_t up16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ int clampi(int i, int n) { return min(max(i, 0), n - 1); }

// The pixel a pad reads for index i of an axis of n: replicate, or numpy's
// "reflect" (edge excluded) within one width of the edge; clamped beyond.
__device__ __forceinline__ int pad_index(int i, int n, bool reflect) {
  if (reflect) i = i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
  return clampi(i, n);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// N lanes at p as f32: one vector access where the lanes make one.
template <int N>
__device__ __forceinline__ void ld_lanes(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = p[n];
  }
}
template <int N>
__device__ __forceinline__ void ld_lanes(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 q = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[k]);
      v[2 * k] = q.x, v[2 * k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = __bfloat162float(p[n]);
  }
}
template <int N>
__device__ __forceinline__ void st_lanes(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) p[n] = v[n];
  }
}
template <int N>
__device__ __forceinline__ void st_lanes(__nv_bfloat16* p, const float (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k)
      reinterpret_cast<__nv_bfloat162*>(p)[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) p[n] = __float2bfloat16(v[n]);
  }
}

// N lanes of T as loaded from global memory (aligned to the whole, so that
// one vector load fills it), converted to f32 only where read, so that a
// load issued early does not hold the thread up until its value is used.
template <int N, typename T>
struct alignas(N * sizeof(T)) Raw {
  T v[N];
  __device__ __forceinline__ void get(float (&o)[N]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) o[n] = ld(v[n]);
  }
};

// cp.async of 4, 8 or 16 bytes into shared memory (completion: wait_all).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait for all but the kPending most recently committed groups.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// N lanes of T from global to shared memory, asynchronously where they make
// a cp.async (4, 8 or 16 bytes, both ends aligned to it).
template <int N, typename T>
__device__ __forceinline__ void copy_lanes(T* dst, const T* src) {
  constexpr int kB = N * static_cast<int>(sizeof(T));
  if constexpr (kB == 4 || kB == 8 || kB == 16) {
    cp_async<kB>(dst, src);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) dst[n] = src[n];
  }
}

// fn(r, c) for every cell of a kRows x kCols box, c fastest, the cells dealt
// to the kThreads threads in turn; each thread steps its (r, c) by a constant.
template <int kThreads, int kRows, int kCols, typename Fn>
__device__ __forceinline__ void for_box(Fn&& fn) {
  constexpr int kDr = kThreads / kCols, kDc = kThreads % kCols;
  int r = threadIdx.x / kCols, c = threadIdx.x % kCols;
#pragma unroll 2
  for (int k = threadIdx.x; k < kRows * kCols; k += kThreads) {
    fn(r, c);
    r += kDr;
    c += kDc;
    if (c >= kCols) {
      c -= kCols;
      ++r;
    }
  }
}

// Polynomial 3x3 stencil (ops.graph.stats_conv) from the centre v and its
// right, down, up and left neighbours, and its reference adjoint (flipped
// taps).
__device__ __forceinline__ float stats5(const Stats& s, float v, float r, float d, float u,
                                        float l) {
  return s.p[0] * v + s.p[1] * (r - v) + s.p[2] * (d - v) + s.p[3] * (4.f * v - u - d - l - r);
}
__device__ __forceinline__ float stats_t5(const Stats& s, float v, float r, float d, float u,
                                          float l) {
  return s.p[0] * v + s.p[1] * (l - v) + s.p[2] * (u - v) + s.p[3] * (4.f * v - u - d - l - r);
}

// Stage 2 at one cell, N lanes: Sg (and Sl) from the x cell xc of X, whose
// rows are kXW cells; the result into cell pc of Sg and Sl.
template <int N, int kXW, bool kGlr, typename TX>
__device__ __forceinline__ void stencil_cell(const TX* __restrict__ X, int xc, const Stats& sg,
                                             const Stats& sl, float* __restrict__ Sg,
                                             float* __restrict__ Sl, int pc) {
  float v[N], r[N], d[N], u[N], l[N], o[N];
  ld_lanes<N>(X + xc * N, v);
  ld_lanes<N>(X + (xc + 1) * N, r);
  ld_lanes<N>(X + (xc + kXW) * N, d);
  ld_lanes<N>(X + (xc - kXW) * N, u);
  ld_lanes<N>(X + (xc - 1) * N, l);
#pragma unroll
  for (int n = 0; n < N; ++n) o[n] = stats5(sg, v[n], r[n], d[n], u[n], l[n]);
  st_lanes<N>(Sg + pc * N, o);
  if (kGlr) {
#pragma unroll
    for (int n = 0; n < N; ++n) o[n] = stats5(sl, v[n], r[n], d[n], u[n], l[n]);
    st_lanes<N>(Sl + pc * N, o);
  }
}

// Stage 3 at one cell inside the image, N lanes, on planes of kPW cells a
// row and kNP cells a weight plane (weights [e][cell][lane]):
//   Ag = sum_e [wei_e(p) - wei_e(p - d_e)],  wei_e(q) = w_e(q) map(w_e(q) (S(q) - S(q + d_e)))
//   Al = Sl(p) - sum_e w_e(p) Sl(p + d_e)
template <int N, int kWin, bool kRe, bool kGlr, int kPW, int kNP, typename TW>
__device__ __forceinline__ void edge_cell(const float* __restrict__ Sg,
                                          const float* __restrict__ Sl,
                                          const TW* __restrict__ Wg, const TW* __restrict__ Wl,
                                          int pc, const float (&gam)[N], float* __restrict__ Ag,
                                          float* __restrict__ Al) {
  float sp[N], acc[N];
  ld_lanes<N>(Sg + pc * N, sp);
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
  for (int e = 0; e < Win<kWin>::E; ++e) {
    const int off = Win<kWin>::dh(e) * kPW + Win<kWin>::dw(e);
    float wp[N], wq[N], sn[N], sq[N];
    ld_lanes<N>(Wg + (e * kNP + pc) * N, wp);
    ld_lanes<N>(Wg + (e * kNP + pc - off) * N, wq);
    ld_lanes<N>(Sg + (pc + off) * N, sn);
    ld_lanes<N>(Sg + (pc - off) * N, sq);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      acc[n] += wp[n] * edge_map<kRe>(wp[n] * (sp[n] - sn[n]), gam[n]);
      acc[n] -= wq[n] * edge_map<kRe>(wq[n] * (sq[n] - sp[n]), gam[n]);
    }
  }
  st_lanes<N>(Ag + pc * N, acc);
  if (kGlr) {
    float s0[N];
    ld_lanes<N>(Sl + pc * N, s0);
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
    for (int e = 0; e < Win<kWin>::E; ++e) {
      const int off = Win<kWin>::dh(e) * kPW + Win<kWin>::dw(e);
      float w[N], sn[N];
      ld_lanes<N>(Wl + (e * kNP + pc) * N, w);
      ld_lanes<N>(Sl + (pc + off) * N, sn);
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] += w[n] * sn[n];
    }
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = s0[n] - acc[n];
    st_lanes<N>(Al + pc * N, acc);
  }
}

// Zero lanes at one cell outside the image (stage 3).
template <int N, bool kGlr>
__device__ __forceinline__ void zero_cell(float* Ag, float* Al, int pc) {
  float z[N];
#pragma unroll
  for (int n = 0; n < N; ++n) z[n] = 0.f;
  st_lanes<N>(Ag + pc * N, z);
  if (kGlr) st_lanes<N>(Al + pc * N, z);
}

// stats^T of plane A at cell pc, N lanes (A is zero outside the image).
template <int N, int kPW>
__device__ __forceinline__ void stats_t_cell(const float* A, int pc, const Stats& s,
                                             float (&t)[N]) {
  float v[N], r[N], d[N], u[N], l[N];
  ld_lanes<N>(A + pc * N, v);
  ld_lanes<N>(A + (pc + 1) * N, r);
  ld_lanes<N>(A + (pc + kPW) * N, d);
  ld_lanes<N>(A + (pc - kPW) * N, u);
  ld_lanes<N>(A + (pc - 1) * N, l);
#pragma unroll
  for (int n = 0; n < N; ++n) t[n] = stats_t5(s, v[n], r[n], d[n], u[n], l[n]);
}

// stats^T of plane A (one lane) at the cell pair pc, pc + 1, pc even: the
// five taps of both from five float2 reads.
template <int kPW>
__device__ __forceinline__ void stats_t_pair(const float* A, int pc, const Stats& s,
                                             float (&t)[2]) {
  float l2[2], v[2], r2[2], u[2], d[2];
  ld_lanes<2>(A + pc - 2, l2);  // columns c - 2, c - 1
  ld_lanes<2>(A + pc, v);       // c, c + 1
  ld_lanes<2>(A + pc + 2, r2);  // c + 2, c + 3
  ld_lanes<2>(A + pc - kPW, u);
  ld_lanes<2>(A + pc + kPW, d);
  t[0] = stats_t5(s, v[0], v[1], d[0], u[0], l2[1]);
  t[1] = stats_t5(s, v[1], r2[0], d[1], u[1], v[0]);
}

}  // namespace ptile
}  // namespace irdu
