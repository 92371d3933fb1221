// Names the cudaError_t codes that the launch entry points return, so the
// Python wrappers can raise with a readable message.
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
