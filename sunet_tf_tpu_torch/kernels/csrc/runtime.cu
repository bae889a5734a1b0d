// The kernel library's CUDA runtime in the calling host thread.
//
// nvcc links this library with its own (static) CUDA runtime, apart from
// PyTorch's, and a runtime keeps state per host thread. The first runtime
// call of the library in a thread it has not run in before (autograd's
// device thread, a rank's worker thread) sets that state up and can leave
// an error behind, which the next launch's cudaGetLastError would report as
// its own. The wrappers call sunet_thread_init once per thread and device
// (kernels/_build.py::stream) before any launch there: it makes `device`
// current for this runtime and drops what the set-up left.

#include <cuda_runtime.h>

extern "C" int sunet_thread_init(int device) {
  const cudaError_t e = cudaSetDevice(device);
  (void)cudaGetLastError();
  return (int)e;
}
