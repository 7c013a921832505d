// Shared C entry point of the kernel library: the text of a CUDA error code,
// for the Python wrapper's exception message.
#include <cuda_runtime.h>

extern "C" const char* pm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
