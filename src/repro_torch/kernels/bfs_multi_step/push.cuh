// Packed top-down ("push") BFS superstep for Q frontiers, shared by the
// Q-frontier kernel (bfs_multi_step/kernel.cu) and its single-frontier
// instance (bfs_step/kernel.cu).
//
// Replaces repro/kernels/bfs_multi_step/kernel.py::multi_bfs_step_packed_pallas
// and repro/kernels/bfs_step/kernel.py::bfs_step_packed_pallas.
//
// Contract (bool = one byte, words = int32 bit patterns read as uint32):
//   frontier bool[Q, R]   adj int32[R, W]   alive bool[V]   visited bool[Q, V]
//   -> reach int32[Q, W]  raw OR of the active rows' words (no liveness mask)
//      parent int32[Q, V] smallest active row (relative to the R-row slice)
//                         with bit c set, where new; -1 elsewhere
//      new bool[Q, V]     reach & alive & !visited
//
// What bounds it: the bytes of the active rows (|frontier rows| * W * 4),
// plus the Q*V bytes of frontier/visited/outputs. The design streams only
// those rows:
//   1. pack_frontier: one warp per 32 frontier rows -> a ballot word, so the
//      scan reads 4 bytes per 32 rows and skips empty row words.
//   2. push_scan: one thread per (query, adjacency word). A warp walks the
//      frontier words of its row range in ascending order, loads the words
//      of active rows only (coalesced: 32 threads = 32 consecutive words of
//      one row), ORs them into reach, and records the first (smallest) row
//      that sets each bit. Rows are split across blocks (gridDim.z) so a
//      block scans at most ROWS_PER_BLOCK rows and small Q still fills the
//      card; the splits combine with atomicOr (reach) and atomicMin
//      (parent). OR and min do not depend on order, so the result is
//      bit-identical to the ascending scan.
//   3. push_epilogue: mask by destination liveness and visited, -1 parents.
// The Pallas kernel's empty-tile skip becomes the per-row frontier-bit skip.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace push {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 128;     // one thread per adjacency word
constexpr int ROWS_PER_BLOCK = 4096;  // upper bound on one block's row range
constexpr int MIN_BLOCKS = 528;       // 4 blocks per SM on 132 SMs
constexpr int32_t NO_PARENT = 0x7fffffff;

__global__ void pack_frontier(const uint8_t* __restrict__ f, int q_n, int r_n,
                              int rw, uint32_t* __restrict__ fw) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(q_n) * rw) return;  // whole warp
  const int q = static_cast<int>(warp / rw);
  const int w = static_cast<int>(warp % rw);
  const int r = (w << 5) + lane;
  const bool bit = r < r_n && f[static_cast<size_t>(q) * r_n + r] != 0;
  const unsigned m = __ballot_sync(FULL, bit);
  if (lane == 0) fw[warp] = m;
}

__global__ void init_outputs(int32_t* __restrict__ parent, long long n_parent,
                             uint32_t* __restrict__ reach, long long n_reach) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_parent || i < n_reach; i += stride) {
    if (i < n_parent) parent[i] = NO_PARENT;
    if (i < n_reach) reach[i] = 0u;
  }
}

// grid: x = word blocks, y = query, z = row split; rows_per_split % 32 == 0
__global__ void __launch_bounds__(SCAN_THREADS)
push_scan(const uint32_t* __restrict__ fw, int rw,
          const uint32_t* __restrict__ adj, int r_n, int w_n, int v_n,
          int rows_per_split, int32_t* __restrict__ parent,
          uint32_t* __restrict__ reach) {
  const int q = blockIdx.y;
  const int w = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool own = w < w_n;
  const int fw0 = (blockIdx.z * rows_per_split) >> 5;
  const int fw1 = min(rw, fw0 + (rows_per_split >> 5));
  const uint32_t* frow = fw + static_cast<size_t>(q) * rw;
  int32_t* prow = parent + static_cast<size_t>(q) * v_n;
  uint32_t acc = 0u, found = 0u;

  for (int base = fw0; base < fw1; base += 32) {
    const uint32_t mine = base + lane < fw1 ? frow[base + lane] : 0u;
    unsigned nz = __ballot_sync(FULL, mine != 0u);
    while (nz) {  // warp-uniform: every lane walks the same rows
      const int j = __ffs(nz) - 1;
      nz &= nz - 1;
      uint32_t bits = __shfl_sync(FULL, mine, j);
      const int rbase = (base + j) << 5;
      while (bits) {
        int rows[4];
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // up to 4 rows in flight
          rows[u] = bits ? rbase + __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a[u] = (own && rows[u] >= 0)
                     ? __ldg(adj + static_cast<size_t>(rows[u]) * w_n + w)
                     : 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // ascending rows: first hit = min
          acc |= a[u];
          uint32_t nb = a[u] & ~found;
          found |= nb;
          while (nb) {
            const int col = (w << 5) + __ffs(nb) - 1;
            nb &= nb - 1;
            if (col < v_n) atomicMin(prow + col, rows[u]);
          }
        }
      }
    }
  }
  if (own && acc) atomicOr(reach + static_cast<size_t>(q) * w_n + w, acc);
}

__global__ void push_epilogue(const uint32_t* __restrict__ reach, int w_n,
                              const uint8_t* __restrict__ alive,
                              const uint8_t* __restrict__ visited, int q_n,
                              int v_n, uint8_t* __restrict__ new_out,
                              int32_t* __restrict__ parent) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(q_n) * v_n) return;
  const int q = static_cast<int>(i / v_n);
  const int c = static_cast<int>(i % v_n);
  const uint32_t word = reach[static_cast<size_t>(q) * w_n + (c >> 5)];
  const bool is_new = ((word >> (c & 31)) & 1u) && alive[c] && !visited[i];
  new_out[i] = is_new;
  if (!is_new) parent[i] = -1;
}

// The whole superstep on ``stream``; fw is caller scratch int32[Q, ceil(R/32)].
inline cudaError_t launch(const void* frontier, const void* adj,
                          const void* alive, const void* visited,
                          void* new_out, void* parent, void* reach, void* fw,
                          int q_n, int r_n, int w_n, int v_n,
                          cudaStream_t stream) {
  if (q_n <= 0 || v_n <= 0) return cudaSuccess;
  const int rw = (r_n + 31) / 32;
  const long long np = static_cast<long long>(q_n) * v_n;
  const long long nr = static_cast<long long>(q_n) * w_n;
  init_outputs<<<static_cast<unsigned>(std::min(4096LL, (np + 255) / 256)),
                 256, 0, stream>>>(static_cast<int32_t*>(parent), np,
                              static_cast<uint32_t*>(reach), nr);
  if (rw > 0) {
    const long long warps = static_cast<long long>(q_n) * rw;
    pack_frontier<<<static_cast<unsigned>((warps * 32 + 255) / 256), 256, 0,
                    stream>>>(static_cast<const uint8_t*>(frontier), q_n, r_n,
                              rw, static_cast<uint32_t*>(fw));
    const int wblocks = (w_n + SCAN_THREADS - 1) / SCAN_THREADS;
    const long long cols = static_cast<long long>(wblocks) * q_n;
    int splits = static_cast<int>((MIN_BLOCKS + cols - 1) / cols);
    splits = std::max(splits, (r_n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    splits = std::max(1, std::min(splits, rw));
    const int words_per_split = (rw + splits - 1) / splits;
    splits = (rw + words_per_split - 1) / words_per_split;
    dim3 grid(wblocks, q_n, splits);
    push_scan<<<grid, SCAN_THREADS, 0, stream>>>(
        static_cast<const uint32_t*>(fw), rw,
        static_cast<const uint32_t*>(adj), r_n, w_n, v_n,
        words_per_split * 32, static_cast<int32_t*>(parent),
        static_cast<uint32_t*>(reach));
  }
  push_epilogue<<<static_cast<unsigned>((np + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint32_t*>(reach), w_n,
      static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(visited), q_n, v_n,
      static_cast<uint8_t*>(new_out), static_cast<int32_t*>(parent));
  return cudaGetLastError();
}

}  // namespace push

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
