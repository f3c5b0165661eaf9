// K7's instances on the cross-4 window (see pixel_unroll.cu): a
// translation unit of their own, so that nvcc builds the windows side by side.

#include "pixel_unroll.cuh"

namespace irdu {
namespace pix {

const Entry kCross4Entry = entry_of<kCross4>();

}  // namespace pix
}  // namespace irdu
