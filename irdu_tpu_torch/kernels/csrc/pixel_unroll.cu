// K7: the whole pixel-family unroll (2 ADMM rounds x 2 CG steps, one scale,
// the diamond-12, cross-4 or ring-8 window, reflect stats pad), CHW. Replaces
// irdu_tpu/ops/pallas/solver_unroll.py:gg_pixel_unroll_chw
// (_pixel_unroll_kernel). The math, the reference quirks and the bound are
// set out in irdu_tpu_torch/ops/pixel_unroll.py; the padded tile's stages
// and boundary rules in padded_tile.cuh.
//
// One persistent cooperative launch (K1's structure, gg_unroll.cu). The
// unroll runs as six phases, each one pass over every (b, g, tile) item,
// separated by grid barriers:
//   1. rhs1 = y + rho Q y                                        -> P0
//   2. CG from x = rhs1:  u0 = -(A - I) rhs1, x1 = rhs1 + a0 u0   -> P1 = x1, P2 = u0
//   3. u1 = rhs1 - A x1 + b1 u0, x2 = x1 + a1 u1                  -> P0 = x2
//   4. rhs2 = y + rho C^T(2 S_gamma(C x2) - C x2), the re-threshold -> P1
//   5. CG from x = rhs2 (round 2 restarts):  u2, x3 = rhs2 + a2 u2 -> P0 = x3, P2 = u2
//   6. u3 = rhs2 - A x3 + b3 u2, out = x3 + a3 u3                 -> out (channel g*F + f)
// A phase reads one scratch plane over a box (x) and others only at its own
// pixels (rhs, prev, y), and never writes the plane it reads over a box, so
// three f32 scratch planes per channel plane hold everything that crosses
// tile borders; phase 3 overwrites rhs1 pixel by pixel after reading it.
// Nothing is rounded between the steps: the arithmetic from y to out is
// f32, as the TPU kernel's is (K5's band route rounds each step's output).
//
// An item is one kTH x kTW output tile of one (b, g); the CTA walks the F
// planes as K5 does: the graph's weight tiles (GTV, and GLR in the CG
// phases) come into shared memory once for all F, plane f + 1's x box comes
// by cp.async into a second buffer while plane f computes, and the stage
// planes lie over boxes not clipped to the image, read by constant offsets.
// y is the un-tiled (B, F, H, W) image, read at plane f. The next item's
// weights and first x box are staged while the current item finishes. The
// grid is as many CTAs as co-reside (one of 512 threads an SM for the
// served bf16 32x64 tile: 198,144 bytes of shared memory on diamond-12, at
// most 128 registers a thread), at most one per item; every CTA reaches every
// barrier. Scratch written before a barrier is read through L2 (cp.async.cg,
// ld.global.cg). The templates are in pixel_unroll.cuh; this file holds the
// C interface and the diamond-12 instances, pixel_unroll_cross4.cu and
// pixel_unroll_ring8.cu the other windows'.

#include "pixel_unroll.cuh"

namespace irdu {
namespace pix {

// The served diamond-12 window's instances compile here, with the C
// interface; the other windows' in pixel_unroll_cross4.cu and pixel_unroll_ring8.cu.
const Entry kDiamond12Entry = entry_of<kDiamond12>();

const Entry& entry(int window) {
  return window == kCross4 ? kCross4Entry
                           : (window == kDiamond12 ? kDiamond12Entry : kRing8Entry);
}

}  // namespace pix
}  // namespace irdu

// Three f32 scratch planes (P0, P1, P2) per channel plane of the output.
extern "C" long long irdu_pixel_unroll_scratch_floats(int H, int W) { return 3LL * H * W; }

// The shared memory one CTA takes on a window in dtype (ops/pixel_unroll.py
// k7_smem_bytes holds its planner to it), or -1 for another window or dtype.
extern "C" long long irdu_pixel_unroll_smem(int window, int dtype) {
  using namespace irdu::pix;
  if (window < kCross4 || window > kRing8) return -1;
  return entry(window).smem(dtype);
}

// The CTAs of the window's and dtype's kernel that fit on one SM (the
// cooperative grid is this times the SM count, at most one per item), or -1.
extern "C" int irdu_pixel_unroll_ctas_per_sm(int window, int dtype) {
  using namespace irdu::pix;
  if (window < kCross4 || window > kRing8) return -1;
  return entry(window).ctas_per_sm(dtype);
}

// y (B, F, H, W); wgtv, wglr (B, G, E, H, W); pgtv, pglr (G, 4, F) f32;
// scal (G, 9) f32; out (B, G*F, H, W); scratch 3 * B*G*F*H*W f32. window: 0
// cross-4, 1 diamond-12, 2 ring-8 (E = 4, 12, 8). The tile follows the dtype
// (tile_of).
extern "C" int irdu_pixel_unroll(const void* y, const void* wgtv, const void* wglr,
                                 const void* pgtv, const void* pglr, const void* scal,
                                 void* out, void* scratch, int B, int G, int F, int H, int W,
                                 int window, int dtype, void* stream) {
  using namespace irdu::pix;
  if (B < 1 || G < 1 || F < 1 || H < 2 || W < 2 || window < kCross4 || window > kRing8 ||
      y == nullptr || wgtv == nullptr || wglr == nullptr || pgtv == nullptr ||
      pglr == nullptr || scal == nullptr || out == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{y, wgtv, wglr, pgtv, pglr, scal, out, scratch, B, G, F, H, W, dtype,
               static_cast<cudaStream_t>(stream)};
  return entry(window).run(c);
}
