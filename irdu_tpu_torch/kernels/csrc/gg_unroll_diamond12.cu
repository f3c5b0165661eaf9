// K1's instances on the diamond-12 window (see gg_unroll.cu), the "edge" pad on
// one and the other pads on a second: a translation unit of their own, so
// that nvcc builds the windows side by side.

#include "gg_unroll.cuh"

namespace irdu {
namespace unroll {

const Entry kDiamond12Entry = entry_of<ptile::kDiamond12>();

}  // namespace unroll
}  // namespace irdu
