// K1's kernel (see gg_unroll.cu): the templates, and the entry of one
// window, whose instances each window's translation unit compiles
// (gg_unroll.cu cross-4, gg_unroll_diamond12.cu, gg_unroll_ring8.cu).
#pragma once

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
  int pad;  // the stencil's pad (step::kPadEdge, kPadZero, kPadReflect)
};

// The step's planes for a phase of the unroll: x, x_add, aux, prev, out, upd.
template <class IO, typename T>
__device__ __forceinline__ IO planes(const Args<T>& a, const typename IO::TX* x,
                                     const float* x_add, const typename IO::TA* aux,
                                     const typename IO::TP* prev, typename IO::TO* out,
                                     typename IO::TU* upd, int epi, int use_x_rhs) {
  return IO{x,       x_add,   aux,     prev,    out,     upd,     a.wgtv0, a.wglr0, a.wgtv1,
            a.wglr1, a.pgtv0, a.pglr0, a.pgtv1, a.pglr1, a.G,     a.F,     a.H,     a.W,
            epi,     use_x_rhs, a.pad};
}

// One phase: the tile step on every (plane, tile) item this CTA takes. The
// CG step's alpha is scal column 6 + alpha_k, x_add's factor column
// 6 + xadd_k (-1: none).
template <int kWin, bool kAnyPad, bool kRethresh, bool kGlr, class IO>
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
    step::step_tile<kWin, kAnyPad, kRethresh, kGlr>(io, k, bg * io.F + f, ty * kTH,
                                                    (tile - ty * tiles_x) * kTW, smem);
  }
}

// The unroll on window kWin, the stencil padded by "edge" or, with kAnyPad,
// by a.pad.
template <typename T, int kWin, bool kAnyPad>
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
  phase<kWin, kAnyPad, false, false>(
      planes<IoA>(a, a.y, nullptr, nullptr, nullptr, a.U, nullptr, step::kEpiAddX, 0), a.scal,
      -1, -1, a.B, smem);
  grid.sync();
  // B. CG step 1 from x = rhs_a -> X (out at cg1)
  if (a.iters == 1) {
    phase<kWin, kAnyPad, false, true>(
        planes<IoB1>(a, U, nullptr, nullptr, nullptr, a.out, nullptr, step::kEpiCg, 1), a.scal,
        0, -1, a.B, smem);
    return;
  }
  phase<kWin, kAnyPad, false, true>(
      planes<IoB>(a, U, nullptr, nullptr, nullptr, a.X, nullptr, step::kEpiCg, 1), a.scal, 0,
      -1, a.B, smem);
  grid.sync();
  // C. the re-threshold from x1 and y: rhs_b -> R
  phase<kWin, kAnyPad, true, false>(
      planes<IoC>(a, X, nullptr, a.y, nullptr, a.R, nullptr, step::kEpiAddAux, 0), a.scal, -1,
      -1, a.B, smem);
  grid.sync();
  // D. CG step 2 from x1: u1 -> U (x1 + a1 u1 is the output at cg2)
  phase<kWin, kAnyPad, false, true>(
      planes<IoD>(a, X, nullptr, R, nullptr, a.iters == 2 ? a.out : nullptr, a.U,
                  step::kEpiCg, 0),
      a.scal, 1, -1, a.B, smem);
  if (a.iters == 2) return;
  grid.sync();
  // E. CG step 3 from x2 = x1 + a1 u1, with b2 u1
  phase<kWin, kAnyPad, false, true>(
      planes<IoE>(a, X, U, R, U, a.out, nullptr, step::kEpiCg, 0), a.scal, 2, 1, a.B, smem);
}

// The CTAs of the kernel that fit on one SM and the device's SM count,
// found once per device (after raising the kernel's shared memory limit);
// a CUDA error status on failure.
template <typename T, int kWin, bool kAnyPad>
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
  auto kern = gg_unroll_kernel<T, kWin, kAnyPad>;
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
template <typename T, int kWin, bool kAnyPad>
int launch(const Args<T>& a, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy<T, kWin, kAnyPad>(&per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long tiles = (long long)((a.W + kTW - 1) / kTW) * ((a.H + kTH - 1) / kTH);
  const long long items = (long long)a.B * a.G * a.F * tiles;
  const int grid = static_cast<int>(std::min<long long>(items, (long long)per_sm * sms));
  Args<T> args = a;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(
      gg_unroll_kernel<T, kWin, kAnyPad>), dim3(grid), dim3(kThreads), params, kSmem, stream));
}

// One window's entry points: the launch, and the CTAs of the dtype's kernel
// that fit on one SM (its "edge" instance's; both instances take the same
// shared memory and launch bounds).
// Each window's instances compile in a translation unit of their own, so
// that nvcc builds the windows side by side; gg_unroll.cu's C interface picks
// one.
struct Entry {
  int (*run_f32)(const Args<float>& a, cudaStream_t s);
  int (*run_bf16)(const Args<__nv_bfloat16>& a, cudaStream_t s);
  cudaError_t (*occupancy)(int dtype, int* per_sm, int* sms);
};

// Each window runs the "edge" pad, the one every model sends, on an instance
// of its own (kAnyPad false: the pad is no run-time branch there; reading it
// at run time made the cross-4 K1 4.5 % slower on an H100, PERF.md §6) and
// the other pads on a second.
template <typename T, int kWin>
int run_window(const Args<T>& a, cudaStream_t s) {
  return a.pad == step::kPadEdge ? launch<T, kWin, false>(a, s) : launch<T, kWin, true>(a, s);
}

template <int kWin>
cudaError_t occupancy_window(int dtype, int* per_sm, int* sms) {
  return dtype == kFloat32 ? occupancy<float, kWin, false>(per_sm, sms)
                           : occupancy<__nv_bfloat16, kWin, false>(per_sm, sms);
}

template <int kWin>
constexpr Entry entry_of() {
  return Entry{&run_window<float, kWin>, &run_window<__nv_bfloat16, kWin>,
               &occupancy_window<kWin>};
}

extern const Entry kCross4Entry, kDiamond12Entry, kRing8Entry;

}  // namespace unroll
}  // namespace irdu

