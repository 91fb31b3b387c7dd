// Dense top-down ("push") BFS superstep for Q frontiers over a uint8
// adjacency, shared by the Q-frontier kernel (bfs_multi_step/kernel.cu, B6)
// and its single-frontier instance (bfs_step/kernel.cu, B7).
//
// Replaces repro/kernels/bfs_multi_step/kernel.py::multi_bfs_step_pallas
// and repro/kernels/bfs_step/kernel.py::bfs_step_pallas.
//
// Contract (bool = one byte):
//   frontier bool[Q, R]   adj uint8[R, V] (nonzero = edge)   alive bool[V]
//   visited bool[Q, V]
//   -> new bool[Q, V]     (OR over q's frontier rows of adj[r, c] != 0)
//                         & alive[c] & !visited[q, c]
//      parent int32[Q, V] smallest frontier row of q (relative to the R-row
//                         slice) with adj[r, c] != 0, where new; -1 elsewhere
//
// What bounds it: the bytes of the active rows (|union of frontier rows| *
// V), read once per group of 64 queries, plus the Q*V bytes of frontier,
// visited and outputs. The Pallas kernel feeds the MXU a [Q, R] @ [R, V]
// product; here the reach needs no product at all, because a hit is
// exactly a row that sets a parent. The design:
//   1. dense_masks: per group of 64 queries, one uint64 query mask per row
//      (bit q: row r is in q's frontier) and one ballot word per 32 rows
//      (some query of the group has the row), so the scan skips empty rows
//      32 at a time, like the Pallas empty-tile skip.
//   2. dense_scan: one thread per 4 columns of one query group. A warp
//      walks the active rows of its row range in ascending order, reads 4
//      bytes of each active row (32 threads = 128 consecutive bytes), and
//      for every query of the row's mask that has not hit the column yet
//      records the row with atomicMin: ascending rows make the first hit
//      the smallest, and atomicMin combines the row splits (gridDim.z),
//      which CUDA blocks do not order, bit-identically. Dead columns are
//      skipped. No [Q, R, V] candidate volume and no Q padding: the last
//      group's mask simply has fewer bits.
//   3. dense_epilogue: new = a parent was recorded & alive & !visited;
//      parent -1 elsewhere.
#pragma once

#include "push.cuh"

namespace dense {

constexpr int SCAN_THREADS = 128;
constexpr int COLS = 4;                   // columns per thread
constexpr int GROUP = 64;                 // queries per uint64 mask

// grid: x = row blocks (R rounded up to whole warps), y = query group
__global__ void dense_masks(const uint8_t* __restrict__ f, int q_n, int r_n,
                            int rw, unsigned long long* __restrict__ qm,
                            uint32_t* __restrict__ act) {
  const int g = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if ((r >> 5) >= rw) return;  // whole warp: rw * 32 >= r_n
  unsigned long long m = 0ull;
  if (r < r_n) {
    const int q1 = min(q_n, (g + 1) * GROUP);
    for (int q = g * GROUP; q < q1; ++q)
      if (f[static_cast<size_t>(q) * r_n + r])
        m |= 1ull << (q - g * GROUP);
    qm[static_cast<size_t>(g) * r_n + r] = m;
  }
  const unsigned bits = __ballot_sync(push::FULL, m != 0ull);
  if (lane == 0) act[static_cast<size_t>(g) * rw + (r >> 5)] = bits;
}

__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ row,
                                          int c0, int v_n, bool aligned) {
  if (aligned && c0 + COLS <= v_n)
    return __ldg(reinterpret_cast<const uint32_t*>(row + c0));
  uint32_t a = 0u;
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    if (c0 + k < v_n) a |= static_cast<uint32_t>(__ldg(row + c0 + k)) << (8 * k);
  return a;
}

// grid: x = column blocks, y = query group, z = row split;
// rows_per_split % 32 == 0
__global__ void __launch_bounds__(SCAN_THREADS)
dense_scan(const unsigned long long* __restrict__ qm,
           const uint32_t* __restrict__ act, int rw,
           const uint8_t* __restrict__ adj, int r_n, int v_n, bool aligned,
           const uint8_t* __restrict__ alive, int rows_per_split,
           int32_t* __restrict__ parent) {
  const int g = blockIdx.y;
  const int c0 = (blockIdx.x * SCAN_THREADS + threadIdx.x) * COLS;
  const int lane = threadIdx.x & 31;
  unsigned live = 0u;  // bit k: column c0 + k exists and is alive
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    if (c0 + k < v_n && alive[c0 + k]) live |= 1u << k;
  const int aw0 = (blockIdx.z * rows_per_split) >> 5;
  const int aw1 = min(rw, aw0 + (rows_per_split >> 5));
  const uint32_t* arow = act + static_cast<size_t>(g) * rw;
  const unsigned long long* gqm = qm + static_cast<size_t>(g) * r_n;
  int32_t* pg = parent + static_cast<size_t>(g) * GROUP * v_n;
  unsigned long long found[COLS] = {0ull, 0ull, 0ull, 0ull};

  for (int base = aw0; base < aw1; base += 32) {
    const uint32_t mine = base + lane < aw1 ? arow[base + lane] : 0u;
    unsigned nz = __ballot_sync(push::FULL, mine != 0u);
    while (nz) {  // warp-uniform: every lane walks the same rows
      const int j = __ffs(nz) - 1;
      nz &= nz - 1;
      uint32_t bits = __shfl_sync(push::FULL, mine, j);
      const int rbase = (base + j) << 5;
      while (bits) {
        int rows[4];
        uint32_t a[4];
        unsigned long long m[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // up to 4 rows in flight
          rows[u] = bits ? rbase + __ffs(bits) - 1 : -1;
          bits &= bits - 1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = live && rows[u] >= 0;
          a[u] = ok ? load4(adj + static_cast<size_t>(rows[u]) * v_n, c0,
                            v_n, aligned)
                    : 0u;
          m[u] = ok ? __ldg(gqm + rows[u]) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // ascending rows: first hit = min
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            if (!((live >> k) & 1u) || !((a[u] >> (8 * k)) & 0xffu)) continue;
            unsigned long long nb = m[u] & ~found[k];
            found[k] |= nb;
            while (nb) {
              const int q = __ffsll(static_cast<long long>(nb)) - 1;
              nb &= nb - 1;
              atomicMin(pg + static_cast<size_t>(q) * v_n + c0 + k, rows[u]);
            }
          }
        }
      }
    }
  }
}

__global__ void dense_epilogue(const uint8_t* __restrict__ alive,
                               const uint8_t* __restrict__ visited, int q_n,
                               int v_n, uint8_t* __restrict__ new_out,
                               int32_t* __restrict__ parent) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(q_n) * v_n) return;
  const int c = static_cast<int>(i % v_n);
  const bool is_new = parent[i] != push::NO_PARENT && alive[c] && !visited[i];
  new_out[i] = is_new;
  if (!is_new) parent[i] = -1;
}

// The whole superstep on ``stream``. Scratch from the caller: qm
// uint64[ceil(Q/64), R] and act int32[ceil(Q/64), ceil(R/32)].
inline cudaError_t launch(const void* frontier, const void* adj,
                          const void* alive, const void* visited,
                          void* new_out, void* parent, void* qm, void* act,
                          int q_n, int r_n, int v_n, cudaStream_t stream) {
  if (q_n <= 0 || v_n <= 0) return cudaSuccess;
  const int groups = (q_n + GROUP - 1) / GROUP;
  const int rw = (r_n + 31) / 32;
  const long long np = static_cast<long long>(q_n) * v_n;
  push::init_outputs<<<static_cast<unsigned>(
                           std::min(4096LL, (np + 255) / 256)),
                       256, 0, stream>>>(static_cast<int32_t*>(parent), np,
                                         nullptr, 0);
  if (rw > 0) {
    dense_masks<<<dim3((rw * 32 + 255) / 256, groups), 256, 0, stream>>>(
        static_cast<const uint8_t*>(frontier), q_n, r_n, rw,
        static_cast<unsigned long long*>(qm), static_cast<uint32_t*>(act));
    const int cblocks =
        (v_n + SCAN_THREADS * COLS - 1) / (SCAN_THREADS * COLS);
    const long long cols = static_cast<long long>(cblocks) * groups;
    int splits = static_cast<int>((push::MIN_BLOCKS + cols - 1) / cols);
    splits = std::max(splits,
                      (r_n + push::ROWS_PER_BLOCK - 1) / push::ROWS_PER_BLOCK);
    splits = std::max(1, std::min(splits, rw));
    const int words_per_split = (rw + splits - 1) / splits;
    splits = (rw + words_per_split - 1) / words_per_split;
    const bool aligned =
        v_n % 4 == 0 && reinterpret_cast<uintptr_t>(adj) % 4 == 0;
    dense_scan<<<dim3(cblocks, groups, splits), SCAN_THREADS, 0, stream>>>(
        static_cast<const unsigned long long*>(qm),
        static_cast<const uint32_t*>(act), rw,
        static_cast<const uint8_t*>(adj), r_n, v_n, aligned,
        static_cast<const uint8_t*>(alive), words_per_split * 32,
        static_cast<int32_t*>(parent));
  }
  dense_epilogue<<<static_cast<unsigned>((np + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(visited), q_n, v_n,
      static_cast<uint8_t*>(new_out), static_cast<int32_t*>(parent));
  return cudaGetLastError();
}

}  // namespace dense
