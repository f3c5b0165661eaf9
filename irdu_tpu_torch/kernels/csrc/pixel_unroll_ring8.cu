// K7's instances on the ring-8 window (see pixel_unroll.cu): a
// translation unit of their own, so that nvcc builds the windows side by side.

#include "pixel_unroll.cuh"

namespace irdu {
namespace pix {

const Entry kRing8Entry = entry_of<kRing8>();

}  // namespace pix
}  // namespace irdu
