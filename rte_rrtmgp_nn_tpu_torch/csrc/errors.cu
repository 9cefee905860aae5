// Error text for the codes the launch entries return.
#include <cuda_runtime.h>

extern "C" const char* rte_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
