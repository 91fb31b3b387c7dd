// B9 and B5: batched lane-ordered edge writes, dense and packed, on sm_90a.
// B9 replaces repro/kernels/edge_update/kernel.py::edge_update_pallas,
// B5 replaces repro/kernels/edge_update/kernel.py::edge_update_packed_pallas.
//
// Contract (in place; the wrappers in ops.py copy first, as JAX returns new
// arrays), lanes i of rows, cols, vals, mask int32[B]:
//   a lane fires when mask[i] > 0; a masked-off lane is never read further
//   (its row and column may be out of range);
//   B9: adj uint8[R, C]    adj[row, col] = (uint8) vals[i]
//   B5: adj int32[R, W]    bit col of row: set when vals[i] > 0, else clear
//   lanes apply in order: on a duplicate (row, col) the last firing lane wins;
//   ecnt int32[R]: += 1 for every firing lane, duplicates included.
// A firing lane whose row is out of range writes nothing; one whose column
// is out of range still bumps ecnt (the JAX oracle drops the write alone).
//
// What bounds it: the bytes of the touched cells or words and ecnt rows
// (a few KB for B = 1,024), so one launch is bound by its latency. Where
// the Pallas kernel scans the whole batch once per 8-row stripe in lane
// order, here one thread per lane decides on its own whether it is the
// last firing lane of its (row, col): it compares with every later lane,
// staged through shared memory (B^2 / 2 compares, 0.5 M at B = 1,024).
// The winners then have distinct targets, so their writes do not race and
// the result is the lane-order result. In the packed form two winners may
// own different bits of one word, so the bit set / clear is an atomicOr /
// atomicAnd, never a read-modify-write; bit 31 is the int32 sign bit and is
// handled as any other bit of the uint32 word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
edge_update_kernel(const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ vals,
                   const int32_t* __restrict__ mask, int b_n, int r_n,
                   int c_n, int stride, void* adj, int32_t* ecnt) {
  __shared__ int s_row[THREADS];
  __shared__ int s_col[THREADS];
  __shared__ bool s_fire[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool fire = i < b_n && mask[i] > 0;
  const int r = fire ? rows[i] : 0;
  const int c = fire ? cols[i] : 0;
  bool winner = fire;
  for (int t0 = blockIdx.x * THREADS; t0 < b_n; t0 += THREADS) {
    const int j = t0 + threadIdx.x;
    const bool fj = j < b_n && mask[j] > 0;
    s_fire[threadIdx.x] = fj;
    s_row[threadIdx.x] = fj ? rows[j] : 0;
    s_col[threadIdx.x] = fj ? cols[j] : 0;
    __syncthreads();
    if (winner) {
      for (int k = 0; k < THREADS; ++k) {
        if (t0 + k > i && s_fire[k] && s_row[k] == r && s_col[k] == c) {
          winner = false;
          break;
        }
      }
    }
    __syncthreads();
  }
  if (!fire || r < 0 || r >= r_n) return;
  atomicAdd(ecnt + r, 1);
  if (!winner || c < 0 || c >= c_n) return;
  if (PACKED) {
    uint32_t* word = static_cast<uint32_t*>(adj) +
                     static_cast<size_t>(r) * stride + (c >> 5);
    const uint32_t bit = 1u << (c & 31);
    if (vals[i] > 0)
      atomicOr(word, bit);
    else
      atomicAnd(word, ~bit);
  } else {
    static_cast<uint8_t*>(adj)[static_cast<size_t>(r) * stride + c] =
        static_cast<uint8_t>(vals[i]);
  }
}

template <bool PACKED>
int run(void* adj, void* ecnt, const void* rows, const void* cols,
        const void* vals, const void* mask, int b_n, int r_n, int c_n,
        int stride, void* stream) {
  if (b_n <= 0) return 0;
  edge_update_kernel<PACKED><<<(b_n + THREADS - 1) / THREADS, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(mask),
      b_n, r_n, c_n, stride, adj, static_cast<int32_t*>(ecnt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B9: adj uint8[r_n, c_n]
extern "C" int edge_update_launch(void* adj, void* ecnt, const void* rows,
                                  const void* cols, const void* vals,
                                  const void* mask, int b_n, int r_n, int c_n,
                                  void* stream) {
  return run<false>(adj, ecnt, rows, cols, vals, mask, b_n, r_n, c_n, c_n,
                    stream);
}

// B5: adj int32[r_n, w_n] words
extern "C" int edge_update_packed_launch(void* adj, void* ecnt,
                                         const void* rows, const void* cols,
                                         const void* vals, const void* mask,
                                         int b_n, int r_n, int w_n,
                                         void* stream) {
  return run<true>(adj, ecnt, rows, cols, vals, mask, b_n, r_n, 32 * w_n,
                   w_n, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
