// K9: the single-scale system matvec x + mu (.) GLR(x) + rho (.) GTV(x),
// cross-4 window, channels-last. Replaces
// irdu_tpu/ops/pallas/solver_matvec.py:fused_system_matvec (_kernel). The
// math, the layouts and the bound are set out in
// irdu_tpu_torch/ops/system_matvec.py.
//
// x and out are (B, H, W, C) with C = G*F, channel c of graph c / F; the edge
// weights are (B, H, W, G, 4), edge order (-1,0), (0,-1), (0,1), (1,0); the
// stencil rows (4, C) and mu, rho (C,) are f32. One CTA per 8x16 output tile
// and per chunk of up to 16 channels. Stages, separated by __syncthreads(),
// over the tile's region (the tile plus a 4-pixel halo, clipped to the
// image), every stage plane f32 in shared memory as [region pixel][channel]:
//   1. X  = x over the region
//   2. Sg = statsGTV(X), Sl = statsGLR(X)            (replicate pad)
//   3. Ag = the zero-padded C^T scatter of w (w (Sg - shift Sg)), into X's
//      space; Al = Sl - sum_e w_e shift_e Sl
//   4. out = x + rho statsGTV^T(Ag) + mu statsGLR^T(Al) over the tile.
// Past an interior region edge a clamped read is wrong; the stencil, the edge
// sum (it reads the stencil plane at p + d_e and p - d_e) and the transposed
// stencil each move that error one pixel inward, 3 in all, so the 4-pixel
// halo (K5's) keeps it off the tile.
//
// Boundaries (irdu_tpu/ops/pallas/solver_matvec.py:19-23): the stencil's
// input x replicates its edge; a shift of a derived plane (the stencil
// output) replicates that plane's own edge, which a read clamped to the
// region gives at an image edge (the region ends there); the C^T scatter and
// the transposed stencil read zeros outside the image, tested against global
// indices.

#include "common.cuh"

namespace irdu {
namespace matvec {

constexpr int kTH = 8, kTW = 16;  // output tile
constexpr int kHalo = 4;
constexpr int kRegion = (kTH + 2 * kHalo) * (kTW + 2 * kHalo);
constexpr int kChunk = 16;  // channels per CTA, at most
constexpr int kThreads = 256;

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
  const void *x, *wl, *wg;  // x (B, H, W, C); the GLR and GTV weights (B, H, W, G, 4)
  const float *pl, *pg;     // (4, C) stencil rows p01, p02a, p02b, p03
  const float *mu, *ro;     // (C,)
  void* out;
  int H, W, C, F, G, tiles_h;
};

// One channel's stencil coefficients, read from the (4, C) rows.
__device__ __forceinline__ Stats stats_of(const float* rows, int C, int ch) {
  Stats s;
#pragma unroll
  for (int k = 0; k < 4; ++k) s.p[k] = rows[k * C + ch];
  return s;
}

// Polynomial 3x3 stencil, replicate pad (the clamp to the region).
__device__ __forceinline__ float stats_at(const float* s, const Region& R, const Stats& p,
                                          int i, int j, int c, int cn) {
  const float v = s[R.at(i, j) * cn + c];
  const float r = s[R.at(i, j + 1) * cn + c], d = s[R.at(i + 1, j) * cn + c];
  const float u = s[R.at(i - 1, j) * cn + c], l = s[R.at(i, j - 1) * cn + c];
  return p.p[0] * v + p.p[1] * (r - v) + p.p[2] * (d - v) + p.p[3] * (4.f * v - u - d - l - r);
}

// Its reference adjoint: flipped taps, zero outside the image.
__device__ __forceinline__ float stats_t_at(const float* s, const Region& R, const Stats& p,
                                            int i, int j, int c, int cn) {
  const float v = s[R.at(i, j) * cn + c];
  const float r0 = j + 1 < R.W ? s[R.at(i, j + 1) * cn + c] : 0.f;
  const float d0 = i + 1 < R.H ? s[R.at(i + 1, j) * cn + c] : 0.f;
  const float u0 = i > 0 ? s[R.at(i - 1, j) * cn + c] : 0.f;
  const float l0 = j > 0 ? s[R.at(i, j - 1) * cn + c] : 0.f;
  return p.p[0] * v + p.p[1] * (l0 - v) + p.p[2] * (u0 - v) +
         p.p[3] * (4.f * v - u0 - d0 - l0 - r0);
}

// sum_e [wei_e(p) - wei_e(p - d_e)], wei_e(q) = w_e(q)^2 (s(q) - s(q + d_e)),
// the second term zero where p - d_e is outside the image. w points at this
// channel's graph in the batch's weights: w_e(i, j) = w[(i W + j) 4 G + e].
template <typename T>
__device__ __forceinline__ float gtv_edge_sum(const float* s, const Region& R, const T* w,
                                              int G4, int i, int j, int c, int cn) {
  const float sp = s[R.at(i, j) * cn + c];
  const T* wp = w + ((size_t)i * R.W + j) * G4;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int dh = dh_of(e), dw = dw_of(e);
    const float we = ld(wp[e]);
    acc += we * we * (sp - s[R.at(i + dh, j + dw) * cn + c]);
    const int qi = i - dh, qj = j - dw;
    if (R.in_image(qi, qj)) {
      const float wq = ld(w[((size_t)qi * R.W + qj) * G4 + e]);
      acc -= wq * wq * (s[R.at(qi, qj) * cn + c] - sp);
    }
  }
  return acc;
}

// s(p) - sum_e w_e(p) s(p + d_e), the random-walk Laplacian of GLR.
template <typename T>
__device__ __forceinline__ float glr_lap(const float* s, const Region& R, const T* w, int G4,
                                         int i, int j, int c, int cn) {
  const T* wp = w + ((size_t)i * R.W + j) * G4;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc += ld(wp[e]) * s[R.at(i + dh_of(e), j + dw_of(e)) * cn + c];
  return s[R.at(i, j) * cn + c] - acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) system_matvec_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, C = a.C, G4 = 4 * a.G;
  const int c0 = blockIdx.x * kChunk;
  const int cn = min(kChunk, C - c0);  // this CTA's channels: c0 + [0, cn)
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
  float* Sg = X + kRegion * kChunk;
  float* Sl = Sg + kRegion * kChunk;
  float* Al = Sl + kRegion * kChunk;

  const size_t pix0 = (size_t)b * H * W;
  const T* x = static_cast<const T*>(a.x) + pix0 * C + c0;
  const T* wg = static_cast<const T*>(a.wg) + pix0 * G4;
  const T* wl = static_cast<const T*>(a.wl) + pix0 * G4;

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
    Sg[k] = stats_at(X, R, stats_of(a.pg, C, c0 + c), i, j, c, cn);
    Sl[k] = stats_at(X, R, stats_of(a.pl, C, c0 + c), i, j, c, cn);
  }
  __syncthreads();
  // 3. the edge sums
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int q = k / cn, c = k - q * cn, li = q / R.rw;
    const int i = R.r0 + li, j = R.c0 + q - li * R.rw;
    const int g4 = (c0 + c) / a.F * 4;
    X[k] = gtv_edge_sum(Sg, R, wg + g4, G4, i, j, c, cn);
    Al[k] = glr_lap(Sl, R, wl + g4, G4, i, j, c, cn);
  }
  __syncthreads();
  // 4. the tile: x + rho stats^T(Ag) + mu stats^T(Al)
  const int tw = tj1 - tj0, nt = (ti1 - ti0) * tw * cn;
  T* out = static_cast<T*>(a.out);
  for (int k = threadIdx.x; k < nt; k += kThreads) {
    const int q = k / cn, c = k - q * cn, qi = q / tw;
    const int i = ti0 + qi, j = tj0 + q - qi * tw;
    const int ch = c0 + c;
    const size_t idx = (pix0 + (size_t)i * W + j) * C + ch;
    const float t = a.ro[ch] * stats_t_at(X, R, stats_of(a.pg, C, ch), i, j, c, cn) +
                    a.mu[ch] * stats_t_at(Al, R, stats_of(a.pl, C, ch), i, j, c, cn);
    st(out + idx, ld(static_cast<const T*>(a.x)[idx]) + t);
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)kRegion * kChunk;  // X/Ag, Sg, Sl, Al
  auto kern = system_matvec_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.C + kChunk - 1) / kChunk, (a.W + kTW - 1) / kTW, B * a.tiles_h);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  const int tiles_h = (H + kTH - 1) / kTH;
  const bool bad = B < 1 || H < 1 || W < 1 || C < 1 || G < 1 || C % G ||
                   (long long)B * tiles_h > 65535 || (W + kTW - 1) / kTW > 65535 ||
                   x == nullptr || wl == nullptr || wg == nullptr || pl == nullptr ||
                   pg == nullptr || mu == nullptr || ro == nullptr || out == nullptr;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, wl, wg, static_cast<const float*>(pl), static_cast<const float*>(pg),
               static_cast<const float*>(mu), static_cast<const float*>(ro), out,
               H, W, C, C / G, G, tiles_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == irdu::kFloat32) return launch<float>(a, B, s);
  if (dtype == irdu::kBFloat16) return launch<__nv_bfloat16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
