// K1: the whole two-scale GGTV+GGLR ADMM/CG unroll of one flagship filtering
// block, CHW, on the cross-4, diamond-12 or ring-8 window with the stencil
// padded by "edge", "zero" or "reflect". Replaces
// irdu_tpu/ops/pallas/solver_unroll.py:gg_unroll_chw (_unroll_kernel; plane
// helpers in solver_chw.py). The math, the reference
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
//
// The kernel's templates are in gg_unroll.cuh; this file holds the C
// interface and the cross-4 instances, gg_unroll_diamond12.cu and
// gg_unroll_ring8.cu the other windows': on each window the "edge" pad on
// one instance, the other pads on a second.

#include "gg_unroll.cuh"

namespace irdu {
namespace unroll {

const Entry kCross4Entry = entry_of<ptile::kCross4>();

const Entry& entry(int window) {
  return window == ptile::kCross4 ? kCross4Entry
                                  : (window == ptile::kDiamond12 ? kDiamond12Entry : kRing8Entry);
}

}  // namespace unroll
}  // namespace irdu

// Three f32 scratch planes (X, R, U) per channel plane of y.
extern "C" long long irdu_gg_unroll_scratch_floats(int H, int W) { return 3LL * H * W; }

// The CTAs of K1 that fit on one SM on the window's "edge" instance of the
// dtype (the cooperative grid is this times the SM count, at
// most one per item), or -1 after a CUDA error or for an unknown window.
extern "C" int irdu_gg_unroll_ctas_per_sm(int window, int dtype) {
  using namespace irdu::unroll;
  if (window < irdu::ptile::kCross4 || window > irdu::ptile::kRing8) return -1;
  int per_sm = -1, sms = 0;
  const cudaError_t err = entry(window).occupancy(dtype, &per_sm, &sms);
  return err == cudaSuccess ? per_sm : -1;
}

// y, out (B, G*F, H, W) and the weights (B, G, E, H, W) / (B, G, E, H/2,
// W/2) in one dtype, E the window's edges; the tables and scal f32; scratch
// 3 * B * G * F * H * W f32. H and W even. window: 0 cross-4, 1 diamond-12,
// 2 ring-8; pad: the stencil's, 0 edge, 1 zero, 2 reflect (H, W >= 4).
extern "C" int irdu_gg_unroll(const void* y, const void* wgtv0, const void* wglr0,
                              const void* wgtv1, const void* wglr1,
                              const void* pgtv0, const void* pglr0,
                              const void* pgtv1, const void* pglr1,
                              const void* scal, void* out, void* scratch, int B,
                              int G, int F, int H, int W, int iters, int window, int pad,
                              int dtype, void* stream) {
  using namespace irdu::unroll;
  if (B < 1 || G < 1 || F < 1 || H < 2 || W < 2 || H % 2 || W % 2 || iters < 1 || iters > 3 ||
      window < irdu::ptile::kCross4 || window > irdu::ptile::kRing8 ||
      pad < irdu::step::kPadEdge || pad > irdu::step::kPadReflect ||
      (pad == irdu::step::kPadReflect && (H < 4 || W < 4)) || y == nullptr || out == nullptr ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const size_t n = (size_t)B * G * F * H * W;
  auto args = [&](auto* t) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(t)>>;
    return Args<T>{
        static_cast<const T*>(y), static_cast<const T*>(wgtv0), static_cast<const T*>(wglr0),
        static_cast<const T*>(wgtv1), static_cast<const T*>(wglr1),
        static_cast<const float*>(pgtv0), static_cast<const float*>(pglr0),
        static_cast<const float*>(pgtv1), static_cast<const float*>(pglr1),
        static_cast<const float*>(scal), static_cast<T*>(out), scr, scr + n, scr + 2 * n,
        B, G, F, H, W, iters, pad};
  };
  const Entry& e = entry(window);
  if (dtype == irdu::kFloat32) return e.run_f32(args(static_cast<float*>(nullptr)), s);
  if (dtype == irdu::kBFloat16) return e.run_bf16(args(static_cast<__nv_bfloat16*>(nullptr)), s);
  return static_cast<int>(cudaErrorInvalidValue);
}
