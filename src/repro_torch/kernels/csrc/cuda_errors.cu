// The CUDA runtime's message for an error code that a kernel's launch
// function returned, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
