// Drifted copy of kernel_pkg_ok (lint fixture of the port's kernel-shape
// sanitizer): ops.py checks x as int64; meta.py says int32. Never built.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;

}  // namespace

namespace toy {

constexpr int SLICE = 16;  // toy::SLICE, not the anonymous TILE
template <bool WIDE>
constexpr int UNROLL = WIDE ? 8 : 4;

struct Stage {
  int32_t rows[TILE];
  uint16_t words[SLICE];
};

}  // namespace toy

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
toy_kernel(const int32_t* __restrict__ x, int n, int32_t* __restrict__ y) {
  __shared__ int32_t buf[TILE][TILE + 1];
  __shared__ toy::Stage stage;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  buf[threadIdx.x % TILE][threadIdx.x / TILE] = i < n ? x[i] : 0;
  stage.rows[threadIdx.x % TILE] = 1 << (threadIdx.x % 31);
  __syncthreads();
  if (i < n) y[i] = buf[threadIdx.x / TILE][threadIdx.x % TILE] + WIDE;
}

extern "C" int toy_launch(const void* x, void* y, int n, int wide,
                          void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  auto s = static_cast<cudaStream_t>(stream);
  if (wide)
    toy_kernel<true><<<blocks, THREADS, 0, s>>>(
        static_cast<const int32_t*>(x), n, static_cast<int32_t*>(y));
  else
    toy_kernel<false><<<blocks, THREADS, 0, s>>>(
        static_cast<const int32_t*>(x), n, static_cast<int32_t*>(y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
