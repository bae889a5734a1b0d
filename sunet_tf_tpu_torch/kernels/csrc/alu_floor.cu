// ALU-rate probe: T repetitions of one elementwise chain per element.
//
// Replaces tools/vpu_floor.py::rate (its kernel _body), the JAX package's
// microbenchmark of the TPU vector unit: y = x, then T times y = op(y) on a
// float32 array, one op per launch:
//   0 fma:  y * 0.999 + 0.001
//   1 exp:  exp(-y) * 0.5 + 0.25
//   2 tanh: tanh(y) * 0.9 + 0.05
//   3 gelu: tanh-form GELU(y) * 0.9 + 0.05
// Each step depends on the last, so nothing folds; the array is read once
// and written once, so the rate of a long chain is the ALU's (FMA pipe, and
// the special-function unit for exp and tanh) and not the memory's.
//
// What bounds it on Hopper: the operations, against the float32 peak
// outside the tensor cores (67 TFLOP/s); exp and tanh also go through the
// special-function unit, at a fraction of the FMA rate.
//
// Design: one thread per element (grid-stride), the chain in a register,
// expf / tanhf at full accuracy (no fast-math), as PyTorch's exp and tanh.
#include <cuda_runtime.h>
#include <math.h>

namespace sunet {

template <int kOp>
__device__ inline float alu_step(float y) {
  if (kOp == 0) return y * 0.999f + 0.001f;
  if (kOp == 1) return expf(-y) * 0.5f + 0.25f;
  if (kOp == 2) return tanhf(y) * 0.9f + 0.05f;
  const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * (y * y * y))));
  return y * cdf * 0.9f + 0.05f;
}

template <int kOp>
__global__ void alu_chain_kernel(const float* __restrict__ x, float* __restrict__ out, size_t n,
                                 int T) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float y = x[i];
    for (int t = 0; t < T; ++t) y = alu_step<kOp>(y);
    out[i] = y;
  }
}

}  // namespace sunet

using namespace sunet;

// out = the chain of op `op` (0 fma, 1 exp, 2 tanh, 3 gelu) applied T times to x (n values).
extern "C" int sunet_alu_chain(const void* x, void* out, long long n, int op, int T,
                               void* stream) {
  if (n < 0 || T < 0 || op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 1 ? 1 : (n + threads - 1) / threads);
  const float* xi = (const float*)x;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (op == 0) alu_chain_kernel<0><<<blocks, threads, 0, st>>>(xi, o, (size_t)n, T);
  else if (op == 1) alu_chain_kernel<1><<<blocks, threads, 0, st>>>(xi, o, (size_t)n, T);
  else if (op == 2) alu_chain_kernel<2><<<blocks, threads, 0, st>>>(xi, o, (size_t)n, T);
  else alu_chain_kernel<3><<<blocks, threads, 0, st>>>(xi, o, (size_t)n, T);
  return (int)cudaGetLastError();
}
