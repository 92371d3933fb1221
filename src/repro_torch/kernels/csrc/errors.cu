// Names the codes that the launch entry points return, so the Python
// wrappers can raise with a readable message: cudaError_t values, and
// 100000 + CUresult where the driver refused a TMA tensor map
// (make_bf16_map in hopper.cuh).
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
  if (code >= 100000)
    return "cuTensorMapEncodeTiled refused a tensor map (the CUresult is the code less 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
