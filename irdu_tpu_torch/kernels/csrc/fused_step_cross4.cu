// K5's instances on the cross-4 window (see fused_step_hopper.cu): a
// translation unit of their own, so that nvcc builds the windows side by side.

#include "fused_step_hopper.cuh"

namespace irdu {
namespace step5 {

const Entry kCross4Entry = entry_of<kCross4>();

}  // namespace step5
}  // namespace irdu
