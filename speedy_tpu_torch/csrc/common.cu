// Error reporting shared by the kernels' C entry points, which each return
// the cudaError_t of their launch.

#include <cuda_runtime.h>

extern "C" const char* speedy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
