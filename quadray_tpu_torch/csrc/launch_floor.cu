// A launch's latency: an empty kernel of one warp, the yardstick that
// chip_smoke.py times beside the launch-bound kernels (the scene pack,
// the update), which do too little work for bytes or operations to bound
// them. No path of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of the empty kernel on ``stream``. Returns the CUDA error.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
