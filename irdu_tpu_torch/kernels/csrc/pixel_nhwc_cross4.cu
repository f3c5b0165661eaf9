// K8's instances on the cross-4 window (see pixel_nhwc.cu): a translation
// unit of their own, so that nvcc builds the windows side by side.

#include "pixel_nhwc.cuh"

namespace irdu {
namespace nhwc {

const Entry kCross4Entry = entry_of<kCross4>();

}  // namespace nhwc
}  // namespace irdu
