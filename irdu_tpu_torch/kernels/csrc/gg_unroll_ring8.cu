// K1's instances on the ring-8 window (see gg_unroll.cu), the "edge" pad on
// one and the other pads on a second: a translation unit of their own, so
// that nvcc builds the windows side by side.

#include "gg_unroll.cuh"

namespace irdu {
namespace unroll {

const Entry kRing8Entry = entry_of<ptile::kRing8>();

}  // namespace unroll
}  // namespace irdu
