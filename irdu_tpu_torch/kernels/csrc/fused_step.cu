// K6a and K6b: the single-scale pieces of K5's unroll step (the system
// matvec and the ADMM re-threshold) on the cross-4 or diamond-12 window,
// CHW. Replaces irdu_tpu/ops/pallas/solver_chw.py:gg_matvec_chw
// (_matvec_kernel) and gtv_rethresh_chw (_rethresh_kernel), K5's oracles
// (K5 itself is fused_step_hopper.cu). The math, the boundary rules and the
// bound are set out in irdu_tpu_torch/ops/fused_step.py.
//
// One CTA per 32x64 output tile of one (b, g, f) plane, running the tile
// step of tile_step.cuh (its stages, boundary rules and shared memory are
// described there), input and output in one type T.

#include "tile_step.cuh"

namespace irdu {
namespace step {

struct Args {
  const void *x, *aux, *prev;
  const void *wg0, *wl0, *wg1, *wl1;  // (B, G, E, H, W) / (B, G, E, H/2, W/2)
  const float *pg0, *pl0, *pg1, *pl1;  // (G, 4, F) stats tables
  const float* scal;                   // (G, 8): mu0, rho0, mu1, rho1, alpha, beta, gamma0, gamma1
  void *out, *upd;
  int G, F, H, W, epi, use_x_rhs, reflect;
};

template <typename T, int kWin, bool kRethresh, bool kGlr, bool kTwoScale>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(Args a) {
  extern __shared__ float smem[];
  const int plane = blockIdx.z;  // (b * G + g) * F + f, a channel plane of x
  const float* sc = a.scal + (plane / a.F) % a.G * 8;
  const Coefs k{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7], 0.f};
  const StepIO<T, T, T, T, T, T, false> io{
      static_cast<const T*>(a.x), nullptr, static_cast<const T*>(a.aux),
      static_cast<const T*>(a.prev), static_cast<T*>(a.out), static_cast<T*>(a.upd),
      static_cast<const T*>(a.wg0), static_cast<const T*>(a.wl0),
      static_cast<const T*>(a.wg1), static_cast<const T*>(a.wl1), a.pg0, a.pl0, a.pg1, a.pl1,
      a.G, a.F, a.H, a.W, a.epi, a.use_x_rhs, a.reflect};
  step_tile<kWin, kRethresh, kGlr, kTwoScale>(io, k, plane, blockIdx.y * kTH, blockIdx.x * kTW,
                                              smem);
}

template <typename T, int kWin, bool kRethresh, bool kGlr, bool kTwoScale>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(kGlr, kTwoScale);
  auto kern = fused_step_kernel<T, kWin, kRethresh, kGlr, kTwoScale>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, B * a.G * a.F);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Single-scale, on either window.
template <typename T, int kWin>
int dispatch_win(const Args& a, int B, bool rethresh, bool glr, cudaStream_t s) {
  if (rethresh) return launch<T, kWin, true, false, false>(a, B, s);
  if (glr) return launch<T, kWin, false, true, false>(a, B, s);
  return launch<T, kWin, false, false, false>(a, B, s);
}

template <typename T>
int dispatch(const Args& a, int B, int win, bool rethresh, bool glr, cudaStream_t s) {
  return win == 0 ? dispatch_win<T, 0>(a, B, rethresh, glr, s)
                  : dispatch_win<T, 1>(a, B, rethresh, glr, s);
}

}  // namespace step
}  // namespace irdu

// x, aux, prev, out, upd (B, G*F, H, W) in one dtype; aux, prev, upd may be
// null; wl0/pl0 are read only with glr; the half-res operands must be null
// (single-scale only). window: 0 cross-4, 1 diamond-12; reflect: the
// stencil's pad (0 replicate, 1 reflect).
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
      two || (rethresh && glr) || epi < kEpiAddX || epi > kEpiCg ||
      window < 0 || window > 1 || (reflect && (H < 2 || W < 2)) ||
      x == nullptr || out == nullptr || wg0 == nullptr || pg0 == nullptr || scal == nullptr ||
      (glr && (wl0 == nullptr || pl0 == nullptr)) ||
      (epi == kEpiCg && !use_x_rhs && aux == nullptr) || (upd != nullptr && epi != kEpiCg);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, aux, prev, wg0, wl0, wg1, wl1,
               static_cast<const float*>(pg0), static_cast<const float*>(pl0),
               static_cast<const float*>(pg1), static_cast<const float*>(pl1),
               static_cast<const float*>(scal), out, upd, G, F, H, W, epi, use_x_rhs,
               reflect};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == irdu::kFloat32) return dispatch<float>(a, B, window, rethresh, glr, s);
  if (dtype == irdu::kBFloat16) return dispatch<__nv_bfloat16>(a, B, window, rethresh, glr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
