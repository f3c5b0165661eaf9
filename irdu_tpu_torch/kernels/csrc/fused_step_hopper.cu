// K5: one unroll step of the GGTV+GGLR solvers (rhs, cg or rethresh; two
// scales for the flagship's band route, one scale for the pixel family's with
// the reflect stencil pad; each on the cross-4, diamond-12 or ring-8 window),
// CHW, input and output in one type T. Replaces
// irdu_tpu/ops/pallas/solver_chw.py:gg_fused_step_chw (_fused_kernel), and
// through its single-scale launches K6a gg_matvec_chw (_matvec_kernel: the
// system, GLR on or off, with the epilogue x + T or T) and K6b
// gtv_rethresh_chw (_rethresh_kernel: [y +] T). The math and the bound are
// set out in irdu_tpu_torch/ops/fused_step.py; the padded tile's stages and
// boundary rules in padded_tile.cuh.
//
// A CTA takes one output tile (kTH x kTW full-res pixels, even, so the half
// tile is whole 2x2 boxes) of one graph g and walks its F channel planes:
//   - the tile's edge weights (both scales) come into shared memory once, in
//     T, and serve all F planes (w_e(p) and w_e(p - d_e) both from there);
//   - plane f + 1's x box comes by cp.async into the second of two buffers
//     while plane f computes;
//   - the half-res stencil reads its box means straight from that x box;
//   - each thread of the epilogue takes a 2x2 box: the half-res term once,
//     then two pairs of pixels (2-element reads of the planes and stores);
//     its global reads are issued when the plane starts (see Pair), the
//     stencil coefficients a plane ahead.
// Shared memory a tile (bf16, cg, 32x64): 4 f32 planes of 36x68 cells and 4
// of 20x36, 2 x boxes of 44x80, the weights of both scales in bf16: 115,456
// bytes, two CTAs an SM. Bound by bytes (ops/fused_step.py); the design
// reads each weight plane once per tile instead of once per channel plane.
// The kernel's templates are in fused_step_hopper.cuh; this file holds the
// C interface and the diamond-12 instances, fused_step_cross4.cu and
// fused_step_ring8.cu the other windows'.

#include "fused_step_hopper.cuh"

namespace irdu {
namespace step5 {

// The served diamond-12 window's instances compile here, with the C
// interface; the other windows' in fused_step_cross4.cu and fused_step_ring8.cu.
const Entry kDiamond12Entry = entry_of<kDiamond12>();

const Entry& entry(int window) {
  return window == kCross4 ? kCross4Entry
                           : (window == kDiamond12 ? kDiamond12Entry : kRing8Entry);
}

}  // namespace step5
}  // namespace irdu

// x, aux, prev, out, upd (B, G*F, H, W) in one dtype; aux, prev, upd may be
// null; wl0/wl1/pl0/pl1 are read only with glr, wg1/wl1/pg1/pl1 only
// two-scale (wg1 non-null). window: 0 cross-4, 1 diamond-12, 2 ring-8;
// reflect: the stencil's pad (0 replicate, 1 reflect).
extern "C" int irdu_fused_step_hopper(const void* x, const void* aux, const void* prev,
                                      const void* wg0, const void* wl0, const void* wg1,
                                      const void* wl1, const void* pg0, const void* pl0,
                                      const void* pg1, const void* pl1, const void* scal,
                                      void* out, void* upd, int B, int G, int F, int H, int W,
                                      int rethresh, int glr, int epi, int use_x_rhs, int window,
                                      int reflect, int dtype, void* stream) {
  using namespace irdu::step5;
  const bool two = wg1 != nullptr;
  const bool bad =
      B < 1 || G < 1 || F < 1 || H < 1 || W < 1 || (long long)B * G > 65535 ||
      (two && (H % 2 || W % 2)) || (rethresh && glr) || epi < kEpiAddX || epi > kEpiCg ||
      window < kCross4 || window > kRing8 || (reflect && (H < 2 || W < 2)) || x == nullptr ||
      out == nullptr || wg0 == nullptr || pg0 == nullptr || scal == nullptr ||
      (two && pg1 == nullptr) ||
      (glr && (wl0 == nullptr || pl0 == nullptr || (two && (wl1 == nullptr || pl1 == nullptr)))) ||
      (epi == kEpiCg && !use_x_rhs && aux == nullptr) || (upd != nullptr && epi != kEpiCg);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, aux, prev, wg0, wl0, wg1, wl1,
               static_cast<const float*>(pg0), static_cast<const float*>(pl0),
               static_cast<const float*>(pg1), static_cast<const float*>(pl1),
               static_cast<const float*>(scal), out, upd, G, F, H, W, epi, use_x_rhs,
               reflect, 0};
  return entry(window).run(a, B, two, rethresh, glr, dtype,
                          static_cast<cudaStream_t>(stream));
}

// The shared memory one CTA of the kernel takes (ops/fused_step.py
// k5_smem_bytes holds its planner to it), or -1 for an unknown window or
// dtype.
extern "C" long long irdu_fused_step_hopper_smem(int window, int two, int glr, int dtype) {
  using namespace irdu::step5;
  if (window < kCross4 || window > kRing8) return -1;
  return entry(window).smem(two != 0, glr != 0, dtype);
}
