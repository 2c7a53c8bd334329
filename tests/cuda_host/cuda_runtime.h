// Just enough of the CUDA runtime to build an elementwise kernel source for
// the host, so that its index arithmetic runs in the CPU tests: a launch
// runs every thread of every block one after another (the kernel must use
// no shared memory and no barriers). The card's SM count and resident
// blocks per SM are HOST_SMS and HOST_BLOCKS_PER_SM.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>

#ifndef HOST_SMS
#define HOST_SMS 4
#endif
#ifndef HOST_BLOCKS_PER_SM
#define HOST_BLOCKS_PER_SM 2
#endif

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(threads)

struct HostDim {
  unsigned x = 0;
};
inline HostDim blockIdx, threadIdx, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = HOST_SMS;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel, int, size_t) {
  *blocks = HOST_BLOCKS_PER_SM;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// the host's float operations round to nearest even, one at a time (built
// with -ffp-contract=off)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
using std::isnan;

// kernel<<<grid, block, 0, stream>>>(args) is rewritten to
// host_launch(kernel, grid, block)(args)
template <typename Kernel>
auto host_launch(Kernel kernel, unsigned grid, unsigned block) {
  return [=](auto... args) {
    gridDim.x = grid;
    for (unsigned b = 0; b < grid; ++b)
      for (unsigned t = 0; t < block; ++t) {
        blockIdx.x = b;
        threadIdx.x = t;
        kernel(args...);
      }
  };
}
