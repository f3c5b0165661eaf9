// K8: one fused segment of the pixel-family unroll (rhs, cg1, cg2 or
// rethresh), channels-last. Replaces
// irdu_tpu/ops/pallas/pixel_nhwc.py:pixel_segment_nhwc (_kernel). The math,
// the layouts and the bound are set out in irdu_tpu_torch/ops/pixel_nhwc.py.
//
// Signals are (B, H, W, C = F*G) in planar order c = f*G + g; the edge weights
// are packed (B, H, W, 12*G), index e*G + g, and broadcast over f. One CTA per
// 8x16 output tile and per chunk of up to 12 channels of one f (the CTAs of a
// tile's chunks are neighbours in the grid, so they share its weights in
// L2). Stages, separated by __syncthreads(), over the tile's region (the
// tile plus a 4-pixel halo, clipped to the image), every stage plane f32 in
// shared memory as [region pixel][channel]:
//   1. X  = x over the region
//   2. Sg = statsGTV(X), and for cg Sl = statsGLR(X)   (reflect pad)
//   3. Ag = the zero-padded C^T scatter of w map(w (Sg - shift Sg)) (into X's
//      space), and for cg Al = Sl - sum_e w_e shift_e Sl
//   4. t  = rho statsGTV^T(Ag) [+ mu statsGLR^T(Al)] over the tile, and the
//      segment's epilogue.
// map is the identity for C^T C and 2 S_gamma(e) - e for the re-threshold.
// The halo is 4 = stats 1 + edge sum 2 + stats^T 1: the edge sum at p reads
// the stencil plane at p + d_e and p - d_e only (distance <= 2). JAX's band
// kernel carries 6 rows because it shifts whole edge-signal arrays.
//
// Reads of a derived plane clamp to the region: at an image edge that
// replicates the plane's own edge, as the reference's shifts do (the stencil
// mirrors there instead); past an interior region edge it reads a wrong value,
// and the error moves one pixel inward per stage and never reaches the tile.
// The C^T scatter and stats^T read zeros outside the image, tested against
// global indices. The same scheme in CHW, one channel per CTA, is what K5's
// single-scale diamond-12 mode needs.

#include "common.cuh"

namespace irdu {
namespace nhwc {

constexpr int kTH = 8, kTW = 16;  // output tile
constexpr int kHalo = 4;
constexpr int kRegion = (kTH + 2 * kHalo) * (kTW + 2 * kHalo);
constexpr int kChunk = 12;  // channels per CTA, at most
constexpr int kThreads = 256;
constexpr int kRhs = 0, kCg1 = 1, kCg2 = 2, kRethresh = 3;  // as in ops/pixel_nhwc.py

struct Region {  // rows [r0, r0 + rh), columns [c0, c0 + rw), inside the image
  int r0, c0, rh, rw, H, W;
  // the local pixel index of (i, j) clamped to the region
  __device__ __forceinline__ int at(int i, int j) const {
    return (min(max(i, r0), r0 + rh - 1) - r0) * rw + min(max(j, c0), c0 + rw - 1) - c0;
  }
  __device__ __forceinline__ bool in_image(int i, int j) const {
    return i >= 0 && i < H && j >= 0 && j < W;
  }
};

struct Args {
  const void *x, *aux, *prev, *wg, *wl;
  const float* p;     // (2, 4): the GTV and GLR stencil coefficients
  const float* scal;  // (5, C): planar rows mu, rho, gamma, alpha, beta
  void *out, *upd;
  int H, W, G, F, gc, tiles_h;
};

// Polynomial 3x3 stencil, reflect pad (edge excluded) at the image edge.
__device__ __forceinline__ float stats_at(const float* s, const Region& R, const float* p,
                                          int i, int j, int c, int cn) {
  const int jr = j + 1 < R.W ? j + 1 : j - 1, jl = j > 0 ? j - 1 : j + 1;
  const int id = i + 1 < R.H ? i + 1 : i - 1, iu = i > 0 ? i - 1 : i + 1;
  const float v = s[R.at(i, j) * cn + c];
  const float r = s[R.at(i, jr) * cn + c], l = s[R.at(i, jl) * cn + c];
  const float d = s[R.at(id, j) * cn + c], u = s[R.at(iu, j) * cn + c];
  return p[0] * v + p[1] * (r - v) + p[2] * (d - v) + p[3] * (4.f * v - u - d - l - r);
}

// Its reference adjoint: flipped taps, zero outside the image.
__device__ __forceinline__ float stats_t_at(const float* s, const Region& R, const float* p,
                                            int i, int j, int c, int cn) {
  const float v = s[R.at(i, j) * cn + c];
  const float r0 = j + 1 < R.W ? s[R.at(i, j + 1) * cn + c] : 0.f;
  const float d0 = i + 1 < R.H ? s[R.at(i + 1, j) * cn + c] : 0.f;
  const float u0 = i > 0 ? s[R.at(i - 1, j) * cn + c] : 0.f;
  const float l0 = j > 0 ? s[R.at(i, j - 1) * cn + c] : 0.f;
  return p[0] * v + p[1] * (l0 - v) + p[2] * (u0 - v) + p[3] * (4.f * v - u0 - d0 - l0 - r0);
}

// sum_e [wei_e(p) - wei_e(p - d_e)], wei_e(q) = w_e(q) map(w_e(q) (s(q) -
// s(q + d_e))), the second term zero where p - d_e is outside the image.
// w points at this channel's graph in the packed weights of the batch:
// w_e(i, j) = w[(i W + j) 12 G + e G].
template <bool kRe, typename T>
__device__ __forceinline__ float gtv_edge_sum(const float* s, const Region& R, const T* w,
                                              int EG, int G, int i, int j, int c, int cn,
                                              float gamma) {
  const float sp = s[R.at(i, j) * cn + c];
  const T* wp_row = w + ((size_t)i * R.W + j) * EG;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kDiamondEdges; ++e) {
    const int dh = d12_dh(e), dw = d12_dw(e);
    const float wp = ld(wp_row[e * G]);
    acc += wp * edge_map<kRe>(wp * (sp - s[R.at(i + dh, j + dw) * cn + c]), gamma);
    const int qi = i - dh, qj = j - dw;
    if (R.in_image(qi, qj)) {
      const float wq = ld(w[((size_t)qi * R.W + qj) * EG + e * G]);
      acc -= wq * edge_map<kRe>(wq * (s[R.at(qi, qj) * cn + c] - sp), gamma);
    }
  }
  return acc;
}

// s(p) - sum_e w_e(p) s(p + d_e), the random-walk Laplacian of GLR.
template <typename T>
__device__ __forceinline__ float glr_lap(const float* s, const Region& R, const T* w, int EG,
                                         int G, int i, int j, int c, int cn) {
  const T* wp_row = w + ((size_t)i * R.W + j) * EG;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kDiamondEdges; ++e)
    acc += ld(wp_row[e * G]) * s[R.at(i + d12_dh(e), j + d12_dw(e)) * cn + c];
  return s[R.at(i, j) * cn + c] - acc;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) pixel_segment_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr bool kGlr = kMode == kCg1 || kMode == kCg2;
  constexpr bool kRe = kMode == kRethresh;
  const int H = a.H, W = a.W, G = a.G, C = a.F * a.G, EG = kDiamondEdges * a.G;
  const int nchunk = (G + a.gc - 1) / a.gc;
  const int f = blockIdx.x / nchunk, g0 = (blockIdx.x % nchunk) * a.gc;
  const int cn = min(a.gc, G - g0);  // this CTA's channels: f*G + g0 + [0, cn)
  const int b = blockIdx.z / a.tiles_h;
  const int ti0 = (blockIdx.z % a.tiles_h) * kTH, tj0 = blockIdx.y * kTW;
  const int ti1 = min(ti0 + kTH, H), tj1 = min(tj0 + kTW, W);
  Region R;
  R.H = H;
  R.W = W;
  R.r0 = max(ti0 - kHalo, 0);
  R.c0 = max(tj0 - kHalo, 0);
  R.rh = min(ti1 + kHalo, H) - R.r0;
  R.rw = min(tj1 + kHalo, W) - R.c0;
  const int n = R.rh * R.rw * cn;

  float* X = smem;  // Ag once the stencils have read X
  float* Sg = X + kRegion * a.gc;
  float* Sl = Sg + kRegion * a.gc;
  float* Al = Sl + kRegion * a.gc;

  const size_t pix0 = (size_t)b * H * W;
  const int c0 = f * G + g0;  // this CTA's first channel
  const T* x = static_cast<const T*>(a.x) + pix0 * C + c0;
  const T* wg = static_cast<const T*>(a.wg) + pix0 * EG + g0;
  const T* wl = kGlr ? static_cast<const T*>(a.wl) + pix0 * EG + g0 : nullptr;
  const float* pg = a.p;
  const float* pl = a.p + 4;

  // 1. x over the region
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int q = k / cn, c = k - q * cn, li = q / R.rw;
    const int i = R.r0 + li, j = R.c0 + q - li * R.rw;
    X[k] = ld(x[((size_t)i * W + j) * C + c]);
  }
  __syncthreads();
  // 2. the stencils
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int q = k / cn, c = k - q * cn, li = q / R.rw;
    const int i = R.r0 + li, j = R.c0 + q - li * R.rw;
    Sg[k] = stats_at(X, R, pg, i, j, c, cn);
    if (kGlr) Sl[k] = stats_at(X, R, pl, i, j, c, cn);
  }
  __syncthreads();
  // 3. the edge sums
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int q = k / cn, c = k - q * cn, li = q / R.rw;
    const int i = R.r0 + li, j = R.c0 + q - li * R.rw;
    const float gamma = kRe ? a.scal[2 * C + c0 + c] : 0.f;
    X[k] = gtv_edge_sum<kRe>(Sg, R, wg + c, EG, G, i, j, c, cn, gamma);
    if (kGlr) Al[k] = glr_lap(Sl, R, wl + c, EG, G, i, j, c, cn);
  }
  __syncthreads();
  // 4. the tile: t and the epilogue
  const int tw = tj1 - tj0, nt = (ti1 - ti0) * tw * cn;
  const T* aux = static_cast<const T*>(a.aux);
  const T* prev = static_cast<const T*>(a.prev);
  T* out = static_cast<T*>(a.out);
  T* upd = static_cast<T*>(a.upd);
  for (int k = threadIdx.x; k < nt; k += kThreads) {
    const int q = k / cn, c = k - q * cn, qi = q / tw;
    const int i = ti0 + qi, j = tj0 + q - qi * tw;
    const int ch = c0 + c;
    float t = a.scal[C + ch] * stats_t_at(X, R, pg, i, j, c, cn);
    if (kGlr) t = a.scal[ch] * stats_t_at(Al, R, pl, i, j, c, cn) + t;
    const size_t idx = (pix0 + (size_t)i * W + j) * C + ch;
    const float xv = ld(static_cast<const T*>(a.x)[idx]);
    float o;
    if (kMode == kRhs) {
      o = xv + t;
    } else if (kMode == kRethresh) {
      o = ld(aux[idx]) + t;
    } else {
      float u = kMode == kCg1 ? -t : ld(aux[idx]) - xv - t;
      if (kMode == kCg2) u += a.scal[4 * C + ch] * ld(prev[idx]);
      if (kMode == kCg1) st(upd + idx, u);
      o = xv + a.scal[3 * C + ch] * u;
    }
    st(out + idx, o);
  }
}

template <typename T, int kMode>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int planes = (kMode == kCg1 || kMode == kCg2) ? 4 : 2;  // X/Ag, Sg [, Sl, Al]
  const size_t smem = sizeof(float) * planes * (size_t)kRegion * a.gc;
  auto kern = pixel_segment_kernel<T, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunk = (a.G + a.gc - 1) / a.gc;
  const dim3 grid(a.F * nchunk, (a.W + kTW - 1) / kTW, B * a.tiles_h);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int mode, cudaStream_t s) {
  switch (mode) {
    case kRhs: return launch<T, kRhs>(a, B, s);
    case kCg1: return launch<T, kCg1>(a, B, s);
    case kCg2: return launch<T, kCg2>(a, B, s);
    case kRethresh: return launch<T, kRethresh>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nhwc
}  // namespace irdu

// x, aux, prev, out, upd (B, H, W, F*G) and wg, wl (B, H, W, 12*G) in one
// dtype; p (2, 4) and scal (5, F*G) f32. rhs reads x, wg; cg1 x, wg, wl and
// writes upd; cg2 x, aux, prev, wg, wl; rethresh x, aux, wg.
extern "C" int irdu_pixel_segment(const void* x, const void* aux, const void* prev,
                                  const void* wg, const void* wl, const void* p,
                                  const void* scal, void* out, void* upd, int B, int H, int W,
                                  int G, int F, int mode, int dtype, void* stream) {
  using namespace irdu::nhwc;
  const int tiles_h = (H + kTH - 1) / kTH;
  const bool glr = mode == kCg1 || mode == kCg2;
  const bool bad =
      B < 1 || H < 2 || W < 2 || G < 1 || F < 1 || mode < kRhs || mode > kRethresh ||
      (long long)B * tiles_h > 65535 || (W + kTW - 1) / kTW > 65535 || x == nullptr ||
      wg == nullptr || p == nullptr || scal == nullptr || out == nullptr ||
      (glr && wl == nullptr) || (mode == kCg1 && upd == nullptr) ||
      ((mode == kCg2 || mode == kRethresh) && aux == nullptr) ||
      (mode == kCg2 && prev == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, aux, prev, wg, wl, static_cast<const float*>(p),
               static_cast<const float*>(scal), out, upd, H, W, G, F,
               G < kChunk ? G : kChunk, tiles_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == irdu::kFloat32) return dispatch<float>(a, B, mode, s);
  if (dtype == irdu::kBFloat16) return dispatch<__nv_bfloat16>(a, B, mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
