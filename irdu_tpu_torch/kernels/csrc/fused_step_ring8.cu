// K5's instances on the ring-8 window (see fused_step_hopper.cu): a
// translation unit of their own, so that nvcc builds the windows side by side.

#include "fused_step_hopper.cuh"

namespace irdu {
namespace step5 {

const Entry kRing8Entry = entry_of<kRing8>();

}  // namespace step5
}  // namespace irdu
