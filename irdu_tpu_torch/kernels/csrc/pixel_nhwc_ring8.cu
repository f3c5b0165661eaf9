// K8's instances on the ring-8 window (see pixel_nhwc.cu): a translation
// unit of their own, so that nvcc builds the windows side by side.

#include "pixel_nhwc.cuh"

namespace irdu {
namespace nhwc {

const Entry kRing8Entry = entry_of<kRing8>();

}  // namespace nhwc
}  // namespace irdu
