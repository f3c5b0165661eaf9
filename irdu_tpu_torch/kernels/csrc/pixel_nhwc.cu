// K8: one fused segment of the pixel-family unroll (rhs, cg1, cg2 or
// rethresh), channels-last, the stencil's reflect pad, on the diamond-12,
// cross-4 or ring-8 window. Replaces
// irdu_tpu/ops/pallas/pixel_nhwc.py:pixel_segment_nhwc (_kernel). The math,
// the layouts and the bound are set out in irdu_tpu_torch/ops/pixel_nhwc.py;
// the padded tile's stages and boundary rules in padded_tile.cuh.
//
// Signals are (B, H, W, C = F*G) in planar order c = f*G + g; the edge weights
// are packed (B, H, W, E*G), index e*G + g, and broadcast over f. A CTA
// takes one kTH x kTW output tile of a group of kN graphs (the CTAs of a
// tile's groups are neighbours in the grid, so they share its rows in L2)
// and walks the F features:
//   - the group's E edge weights of the tile (kN lanes of each packed row,
//     one cp.async of 4-16 bytes a pixel and edge) come into shared memory
//     once and serve all F features;
//   - feature f + 1's x box (kN lanes a pixel, from the reflected pixel past
//     the image edge) comes by cp.async into the second of two buffers while
//     feature f computes, and stays there for the epilogue;
//   - every stage works on a pixel's kN lanes with vector shared-memory
//     accesses; stage planes are [cell][lane].
// The tile's halo is 2 + r, r the window's radius (stencil 1, edge sum r,
// stencil^T 1): on diamond-12 a 16x32 tile computes its stencils on 22x38
// cells (1.63x the outputs; 3.0x with the 8x16 tiles of the first port).
// Shared memory (bf16, cg, 16x32, 4 lanes, the served plan): 229,376 bytes on
// diamond-12, one CTA an SM; 151,616 on ring-8 and 105,536 on cross-4. Bound
// by bytes (on diamond-12 the weights are 4/3 of a cg segment's). The
// templates are in pixel_nhwc.cuh; this file holds the C interface and the
// diamond-12 instances, pixel_nhwc_cross4.cu and pixel_nhwc_ring8.cu the
// other windows'.

#include "pixel_nhwc.cuh"

namespace irdu {
namespace nhwc {

// The served diamond-12 window's instances compile here, with the C
// interface; the other windows' in pixel_nhwc_cross4.cu and pixel_nhwc_ring8.cu.
const Entry kDiamond12Entry = entry_of<kDiamond12>();

const Entry& entry(int window) {
  return window == kCross4 ? kCross4Entry
                           : (window == kDiamond12 ? kDiamond12Entry : kRing8Entry);
}

}  // namespace nhwc
}  // namespace irdu

// x, aux, prev, out, upd (B, H, W, F*G) and wg, wl (B, H, W, E*G) in one
// dtype; p (2, 4) and scal (5, F*G) f32. rhs reads x, wg; cg1 x, wg, wl and
// writes upd; cg2 x, aux, prev, wg, wl; rethresh x, aux, wg. window: 0
// cross-4, 1 diamond-12, 2 ring-8; plan: the tile plan (ops/pixel_nhwc.py
// K8_PLANS; plan 1 in bf16 only).
extern "C" int irdu_pixel_segment(const void* x, const void* aux, const void* prev,
                                  const void* wg, const void* wl, const void* p,
                                  const void* scal, void* out, void* upd, int B, int H, int W,
                                  int G, int F, int mode, int window, int plan, int dtype,
                                  void* stream) {
  using namespace irdu::nhwc;
  const bool glr = mode == kCg1 || mode == kCg2;
  const bool bad =
      B < 1 || B > 65535 || H < 2 || W < 2 || G < 1 || F < 1 || mode < kRhs ||
      mode > kRethresh || window < kCross4 || window > kRing8 || plan < 0 ||
      plan >= kNumPlans || x == nullptr || wg == nullptr ||
      p == nullptr || scal == nullptr || out == nullptr || (glr && wl == nullptr) ||
      (mode == kCg1 && upd == nullptr) || ((mode == kCg2 || mode == kRethresh) && aux == nullptr) ||
      (mode == kCg2 && prev == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, aux, prev, wg, wl, static_cast<const float*>(p),
               static_cast<const float*>(scal), out, upd, H, W, G, F, 0, 0};
  return entry(window).run(a, B, mode, plan, dtype, static_cast<cudaStream_t>(stream));
}

// The shared memory one CTA of the kernel takes on a window in a mode with
// GLR (cg1, cg2) or without, or -1 for a plan it does not have.
extern "C" long long irdu_pixel_segment_smem(int window, int glr, int plan, int dtype) {
  using namespace irdu::nhwc;
  if (window < kCross4 || window > kRing8) return -1;
  return entry(window).smem(glr != 0, plan, dtype);
}
