// K1: the whole two-scale GGTV+GGLR ADMM/CG unroll of one flagship filtering
// block, CHW. Replaces irdu_tpu/ops/pallas/solver_unroll.py:gg_unroll_chw
// (_unroll_kernel; plane helpers in solver_chw.py). The math, the reference
// quirks and the bound are set out in irdu_tpu_torch/ops/solver_unroll.py.
//
// One persistent cooperative launch. The unroll runs as the phases of the
// band route, each one pass over every 32x64 output tile (plus its 4-pixel
// halo) of every (b, g, f) plane with the tile step of tile_step.cuh, all
// stage planes in shared memory:
//   A. rhs_a = y + rho0 Q0 y + Up(rho1 Q1 Dn y)                   -> U
//   B. CG step 1 from x = rhs_a: x1 = x + a0 (x - A x)           -> X (out at cg1)
//   C. rhs_b = y + rho0 C0^T map(C0 x1) + Up(...), re-threshold  -> R
//   D. CG step 2: u1 = rhs_b - A x1                               -> U
//      (at cg2 the output is x1 + a1 u1)
//   E. CG step 3 on x2 = x1 + a1 u1 (formed as it is read, in f32):
//      out = x2 + a2 (rhs_b - A x2 + b2 u1)
// Only x, rhs_b and u cross tile borders; they live in three f32 scratch
// planes per channel plane (X, R, U), and y, the weights and out are read and
// written in the input type. Nothing is rounded between the steps: the
// arithmetic from y to out is f32, as the TPU kernel's is (the band route of
// K5 rounds each step's output to y's type instead).
//
// Each CTA loops over (plane, tile) items, the F feature planes of one graph
// back to back on the same tile so that the graph's weight tiles are shared
// through L2, and a grid barrier (cooperative_groups grid sync) separates the
// phases. Every CTA reaches every barrier: eval_cg_iters is the same for all,
// and a CTA with no item left goes straight to the barrier. The grid is as
// many CTAs as fit on the card at once (two per SM: 76.8 KB of shared memory
// and at most 128 registers a thread each), at most one per item. Scratch
// that other CTAs wrote before a barrier is read through L2 (ld.global.cg).

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "tile_step.cuh"

namespace irdu {
namespace unroll {

namespace cg = cooperative_groups;
using step::Coefs;
using step::kThreads;
using step::kTH;
using step::kTW;
using step::StepIO;

constexpr int kCtasPerSm = 2;
constexpr size_t kSmem = step::kTileSmem;

template <typename T>
struct Args {
  const T *y, *wgtv0, *wglr0, *wgtv1, *wglr1;
  const float *pgtv0, *pglr0, *pgtv1, *pglr1;  // (G, 4, F) stats tables
  const float* scal;  // (G, 10): mu0, ro0, mu1, ro1, gam0, gam1, a0, a1, a2, b2
  T* out;
  float *X, *R, *U;  // f32 scratch, each (B, G*F, H, W)
  int B, G, F, H, W, iters;
};

// The step's planes for a phase of the unroll: x, x_add, aux, prev, out, upd.
template <class IO, typename T>
__device__ __forceinline__ IO planes(const Args<T>& a, const typename IO::TX* x,
                                     const float* x_add, const typename IO::TA* aux,
                                     const typename IO::TP* prev, typename IO::TO* out,
                                     typename IO::TU* upd, int epi, int use_x_rhs) {
  return IO{x,       x_add,   aux,     prev,    out,     upd,     a.wgtv0, a.wglr0, a.wgtv1,
            a.wglr1, a.pgtv0, a.pglr0, a.pgtv1, a.pglr1, a.G,     a.F,     a.H,     a.W,
            epi,     use_x_rhs};
}

// One phase: the tile step on every (plane, tile) item this CTA takes. The
// CG step's alpha is scal column 6 + alpha_k, x_add's factor column
// 6 + xadd_k (-1: none).
template <bool kRethresh, bool kGlr, class IO>
__device__ void phase(const IO& io, const float* scal, int alpha_k, int xadd_k, int B,
                      float* smem) {
  const int tiles_x = (io.W + kTW - 1) / kTW;
  const int tiles = tiles_x * ((io.H + kTH - 1) / kTH);
  const int items = B * io.G * tiles * io.F;  // (bg, tile, f), f fastest
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int f = it % io.F, rest = it / io.F;
    const int tile = rest % tiles, bg = rest / tiles;
    const float* sc = scal + bg % io.G * 10;
    const Coefs k{sc[0], sc[1], sc[2], sc[3], alpha_k >= 0 ? sc[6 + alpha_k] : 0.f, sc[9],
                  sc[4], sc[5], xadd_k >= 0 ? sc[6 + xadd_k] : 0.f};
    const int ty = tile / tiles_x;
    step::step_tile<kRethresh, kGlr>(io, k, bg * io.F + f, ty * kTH,
                                     (tile - ty * tiles_x) * kTW, smem);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) gg_unroll_kernel(Args<T> a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  // StepIO<weights and y, x, aux, prev, out, upd>: f32 for the scratch planes
  using IoA = StepIO<T, T, float, float, float, float, true>;
  using IoB = StepIO<T, float, float, float, float, float, true>;
  using IoB1 = StepIO<T, float, float, float, T, float, true>;
  using IoC = StepIO<T, float, T, float, float, float, true>;
  using IoD = StepIO<T, float, float, float, T, float, true>;
  using IoE = StepIO<T, float, float, float, T, float, true, true>;
  const float* X = a.X;
  const float* R = a.R;
  const float* U = a.U;
  // A. rhs_a from y -> U
  phase<false, false>(planes<IoA>(a, a.y, nullptr, nullptr, nullptr, a.U, nullptr,
                                  step::kEpiAddX, 0), a.scal, -1, -1, a.B, smem);
  grid.sync();
  // B. CG step 1 from x = rhs_a -> X (out at cg1)
  if (a.iters == 1) {
    phase<false, true>(planes<IoB1>(a, U, nullptr, nullptr, nullptr, a.out, nullptr,
                                    step::kEpiCg, 1), a.scal, 0, -1, a.B, smem);
    return;
  }
  phase<false, true>(planes<IoB>(a, U, nullptr, nullptr, nullptr, a.X, nullptr, step::kEpiCg,
                                 1), a.scal, 0, -1, a.B, smem);
  grid.sync();
  // C. the re-threshold from x1 and y: rhs_b -> R
  phase<true, false>(planes<IoC>(a, X, nullptr, a.y, nullptr, a.R, nullptr, step::kEpiAddAux,
                                 0), a.scal, -1, -1, a.B, smem);
  grid.sync();
  // D. CG step 2 from x1: u1 -> U (x1 + a1 u1 is the output at cg2)
  phase<false, true>(planes<IoD>(a, X, nullptr, R, nullptr, a.iters == 2 ? a.out : nullptr,
                                  a.U, step::kEpiCg, 0), a.scal, 1, -1, a.B, smem);
  if (a.iters == 2) return;
  grid.sync();
  // E. CG step 3 from x2 = x1 + a1 u1, with b2 u1
  phase<false, true>(planes<IoE>(a, X, U, R, U, a.out, nullptr, step::kEpiCg, 0), a.scal, 2,
                     1, a.B, smem);
}

// The CTAs of the kernel that fit on one SM and the device's SM count,
// found once per device (after raising the kernel's shared memory limit);
// a CUDA error status on failure.
template <typename T>
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
  auto kern = gg_unroll_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads, kSmem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) {
    cached_per_sm[dev] = *per_sm;
    cached_sms[dev] = *sms;
  }
  return err;
}

// A refused cooperative launch (too many CTAs to be co-resident) returns its
// error; nothing falls back.
template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy<T>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long tiles = (long long)((a.W + kTW - 1) / kTW) * ((a.H + kTH - 1) / kTH);
  const long long items = (long long)a.B * a.G * a.F * tiles;
  const int grid = static_cast<int>(std::min<long long>(items, (long long)per_sm * sms));
  Args<T> args = a;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(
      gg_unroll_kernel<T>), dim3(grid), dim3(kThreads), params, kSmem, stream));
}

}  // namespace unroll
}  // namespace irdu

// Three f32 scratch planes (X, R, U) per channel plane of y.
extern "C" long long irdu_gg_unroll_scratch_floats(int H, int W) { return 3LL * H * W; }

// The CTAs of K1 that fit on one SM (the cooperative grid is this times the
// SM count, at most one per item), or -1 after a CUDA error.
extern "C" int irdu_gg_unroll_ctas_per_sm(int dtype) {
  int per_sm = -1, sms = 0;
  const cudaError_t err = dtype == irdu::kFloat32
                              ? irdu::unroll::occupancy<float>(&per_sm, &sms)
                              : irdu::unroll::occupancy<__nv_bfloat16>(&per_sm, &sms);
  return err == cudaSuccess ? per_sm : -1;
}

// y, out (B, G*F, H, W) and the weights in one dtype; the tables and scal
// f32; scratch 3 * B * G * F * H * W f32. H and W even.
extern "C" int irdu_gg_unroll(const void* y, const void* wgtv0, const void* wglr0,
                              const void* wgtv1, const void* wglr1,
                              const void* pgtv0, const void* pglr0,
                              const void* pgtv1, const void* pglr1,
                              const void* scal, void* out, void* scratch, int B,
                              int G, int F, int H, int W, int iters, int dtype,
                              void* stream) {
  if (B < 1 || G < 1 || F < 1 || H < 2 || W < 2 || H % 2 || W % 2 || iters < 1 || iters > 3 ||
      y == nullptr || out == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const size_t n = (size_t)B * G * F * H * W;
  auto args = [&](auto* t) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(t)>>;
    return irdu::unroll::Args<T>{
        static_cast<const T*>(y), static_cast<const T*>(wgtv0), static_cast<const T*>(wglr0),
        static_cast<const T*>(wgtv1), static_cast<const T*>(wglr1),
        static_cast<const float*>(pgtv0), static_cast<const float*>(pglr0),
        static_cast<const float*>(pgtv1), static_cast<const float*>(pglr1),
        static_cast<const float*>(scal), static_cast<T*>(out), scr, scr + n, scr + 2 * n,
        B, G, F, H, W, iters};
  };
  if (dtype == irdu::kFloat32)
    return irdu::unroll::launch(args(static_cast<float*>(nullptr)), s);
  if (dtype == irdu::kBFloat16)
    return irdu::unroll::launch(args(static_cast<__nv_bfloat16*>(nullptr)), s);
  return static_cast<int>(cudaErrorInvalidValue);
}
