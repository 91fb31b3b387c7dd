// Packed top-down ("push") BFS superstep for Q frontiers: B1, launched by
// bfs_multi_step/kernel.cu (the single-frontier B3 has a kernel of its
// own in bfs_step/kernel.cu, which takes nonzero_bytes from here).
//
// Replaces repro/kernels/bfs_multi_step/kernel.py::multi_bfs_step_packed_pallas.
//
// Contract (bool = one byte, words = int32 bit patterns read as uint32):
//   frontier bool[Q, R]   adj int32[R, W]   alive bool[V]   visited bool[Q, V]
//   -> reach int32[Q, W]  raw OR of the active rows' words (no liveness mask)
//      parent int32[Q, V] smallest active row (relative to the R-row slice)
//                         with bit c set, where new; -1 elsewhere; not
//                         written when the caller asks for no parents
//      new bool[Q, V]     reach & alive & !visited
//
// What bounds it: the bytes of the active rows (|frontier rows| * W * 4,
// each row once), plus the Q*V bytes of frontier, visited and the outputs
// (4 bytes a column for the parent). On the chip it is neither: the time
// follows the longest chain of dependent row loads a block walks, and the
// frontiers of one launch are skewed (chip_smoke.py phase 6 logs the
// largest query's rows against the mean). The design:
//   1. pack_frontier: one thread per 32 frontier rows (two 16-byte loads)
//      -> a bit word, so a walk reads 4 bytes per 32 rows and skips empty
//      row words.
//   2. With parents, and without them at small Q: push_scan, one thread per
//      (query, adjacency word); a block walks the frontier rows of one
//      2,048-row range of its query in ascending order (4 row loads in
//      flight, coalesced: 128 threads = 128 consecutive words of one row),
//      ORs them into reach and records each column's first (smallest) row.
//      The ranges are what keeps the largest query's walk short; they
//      combine with atomicMin (parent) and atomicOr (reach) over an
//      init_outputs pass, and push_epilogue masks by liveness and visited.
//      OR and min do not depend on order, so the result is bit-identical
//      to the ascending scan. (A block that owns a query's tile outright,
//      without ranges or atomics, was slower at Q = 64 on the H100: the
//      largest query's walk is then one block's.)
//   3. push_group, in closure mode (no parents) once Q / 32 x column blocks
//      fills the card (the index builds' Q = 1,024): a block owns a
//      4,096-column tile for 32 queries; the frontier is packed transposed
//      ([rows/32, Q]), so one coalesced load gives the 32 queries' bits of
//      32 rows, and each row any of them holds is loaded ONCE and ORed
//      (shared atomicOr) into the reach of every query that holds it; its
//      4 sub-walkers of 128 threads take a quarter of the rows each. The
//      block writes new and reach itself: no init, no epilogue pass.
// Without parents nothing records or writes a parent.
// The Pallas kernel's empty-tile skip becomes the per-row frontier-bit skip.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace push {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 128;                // one thread per adjacency word
constexpr int TILE_COLS = SCAN_THREADS * 32;     // columns a push_group block owns
constexpr int SPLIT_WORDS = 64;  // frontier words (2,048 rows) a split scans
constexpr int SUBS = 4;          // row sub-walkers of a push_group block
constexpr int GROUP = 32;        // queries of a push_group block
constexpr int PREFETCH = 8;      // frontier words push_group loads at once
constexpr int MIN_BLOCKS = 528;  // 4 blocks per SM on 132 SMs
constexpr int32_t NO_PARENT = 0x7fffffff;

// Bit i set where byte i of ``x`` is nonzero (4 bits).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) |
         (x & 0xff0000u ? 4u : 0u) | (x & 0xff000000u ? 8u : 0u);
}

// fw[q, w] (or fw[w, q] when TRANSPOSED) = bits of frontier rows 32w..+31;
// one thread per word, two 16-byte loads when rows are 16-byte aligned
template <bool TRANSPOSED>
__global__ void pack_frontier(const uint8_t* __restrict__ f, int q_n, int r_n,
                              int rw, bool vec, uint32_t* __restrict__ fw) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(q_n) * rw) return;
  const int q = static_cast<int>(TRANSPOSED ? i % q_n : i / rw);
  const int w = static_cast<int>(TRANSPOSED ? i / q_n : i % rw);
  const uint8_t* p = f + static_cast<size_t>(q) * r_n + (w << 5);
  uint32_t m = 0u;
  if (vec && (w << 5) + 32 <= r_n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    m = nonzero_bytes(a.x) | nonzero_bytes(a.y) << 4 |
        nonzero_bytes(a.z) << 8 | nonzero_bytes(a.w) << 12 |
        nonzero_bytes(b.x) << 16 | nonzero_bytes(b.y) << 20 |
        nonzero_bytes(b.z) << 24 | nonzero_bytes(b.w) << 28;
  } else {
    for (int k = 0; k < 32 && (w << 5) + k < r_n; ++k)
      if (p[k]) m |= 1u << k;
  }
  fw[i] = m;
}

// Closure mode (no parents) at large Q. grid: x = 4,096-column tiles, y =
// groups of GROUP queries. Each row any query of the group holds is loaded
// once and ORed into the reach of every query that holds it (shared
// atomicOr: the SUBS sub-walkers share the accumulators). fw_t is the
// packed frontier transposed, uint32[ceil(R/32), Q].
__global__ void __launch_bounds__(SCAN_THREADS * SUBS, 2)
push_group(const uint32_t* __restrict__ fw_t, int rw, int q_n,
           const uint32_t* __restrict__ adj, int w_n, int v_n,
           const uint8_t* __restrict__ alive,
           const uint8_t* __restrict__ visited, uint8_t* __restrict__ new_out,
           uint32_t* __restrict__ reach) {
  __shared__ uint32_t acc_s[GROUP][SCAN_THREADS];
  const int sub = threadIdx.x / SCAN_THREADS;
  const int t = threadIdx.x % SCAN_THREADS;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * GROUP;
  const int w = blockIdx.x * SCAN_THREADS + t;
  const bool own = w < w_n;
  for (int i = threadIdx.x; i < GROUP * SCAN_THREADS; i += blockDim.x)
    (&acc_s[0][0])[i] = 0u;
  __syncthreads();
  const int per = (rw + SUBS - 1) / SUBS;  // this sub-walker's frontier words
  const int fw0 = min(rw, sub * per), fw1 = min(rw, fw0 + per);
  const bool in_q = q0 + lane < q_n;
  for (int base = fw0; base < fw1; base += PREFETCH) {
    uint32_t m[PREFETCH];  // lane = query: its frontier bits of 32 rows
#pragma unroll
    for (int k = 0; k < PREFETCH; ++k)
      m[k] = (in_q && base + k < fw1)
                 ? __ldg(fw_t + static_cast<size_t>(base + k) * q_n + q0 +
                         lane)
                 : 0u;
#pragma unroll
    for (int k = 0; k < PREFETCH; ++k) {
      uint32_t u = __reduce_or_sync(FULL, m[k]);  // rows some query holds
      const int rbase = (base + k) << 5;
      while (u) {  // warp-uniform
        int rows[4];
        uint32_t qm[4], a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // up to 4 rows in flight
          const int b = u ? __ffs(u) - 1 : -1;
          u &= u - 1;
          rows[j] = b < 0 ? -1 : rbase + b;
          qm[j] = __ballot_sync(FULL, b >= 0 && ((m[k] >> b) & 1u));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = (own && rows[j] >= 0)
                     ? __ldg(adj + static_cast<size_t>(rows[j]) * w_n + w)
                     : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!a[j]) continue;
          for (uint32_t mm = qm[j]; mm; mm &= mm - 1)
            atomicOr(&acc_s[__ffs(mm) - 1][t], a[j]);
        }
      }
    }
  }
  __syncthreads();
  const int nq = min(GROUP, q_n - q0);
  for (int i = threadIdx.x; i < nq * SCAN_THREADS; i += blockDim.x) {
    const int j = i / SCAN_THREADS, tw = i % SCAN_THREADS;
    const int ww = blockIdx.x * SCAN_THREADS + tw;
    if (ww < w_n) reach[static_cast<size_t>(q0 + j) * w_n + ww] = acc_s[j][tw];
  }
  const int c0 = blockIdx.x * TILE_COLS;
  const int n = min(TILE_COLS, v_n - c0);
  for (int j = 0; j < nq; ++j) {
    const size_t qo = static_cast<size_t>(q0 + j) * v_n + c0;
    for (int c = threadIdx.x; c < n; c += SCAN_THREADS * SUBS)
      new_out[qo + c] = ((acc_s[j][c >> 5] >> (c & 31)) & 1u) &&
                        alive[c0 + c] && !visited[qo + c];
  }
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
template <bool PARENTS>
__global__ void __launch_bounds__(SCAN_THREADS)
push_scan(const uint32_t* __restrict__ fw, int rw,
          const uint32_t* __restrict__ adj, int w_n, int v_n,
          int rows_per_split, int32_t* __restrict__ parent,
          uint32_t* __restrict__ reach) {
  const int q = blockIdx.y;
  const int w = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool own = w < w_n;
  const int fw0 = (blockIdx.z * rows_per_split) >> 5;
  const int fw1 = min(rw, fw0 + (rows_per_split >> 5));
  const uint32_t* frow = fw + static_cast<size_t>(q) * rw;
  int32_t* prow = PARENTS ? parent + static_cast<size_t>(q) * v_n : nullptr;
  uint32_t acc = 0u;

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
          uint32_t nb = a[u] & ~acc;
          acc |= a[u];
          while (PARENTS && nb) {
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

// grid: x = blocks of 256 columns, y = query
template <bool PARENTS>
__global__ void push_epilogue(const uint32_t* __restrict__ reach, int w_n,
                              const uint8_t* __restrict__ alive,
                              const uint8_t* __restrict__ visited, int v_n,
                              uint8_t* __restrict__ new_out,
                              int32_t* __restrict__ parent) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= v_n) return;
  const size_t i = static_cast<size_t>(blockIdx.y) * v_n + c;
  const uint32_t word = reach[static_cast<size_t>(blockIdx.y) * w_n + (c >> 5)];
  const bool is_new = ((word >> (c & 31)) & 1u) && alive[c] && !visited[i];
  new_out[i] = is_new;
  if (PARENTS && !is_new) parent[i] = -1;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

template <bool PARENTS>
cudaError_t launch_impl(const void* frontier, const void* adj,
                        const void* alive, const void* visited, void* new_out,
                        void* parent, void* reach, void* fw, int q_n, int r_n,
                        int w_n, int v_n, cudaStream_t stream) {
  const int rw = (r_n + 31) / 32;
  const long long words = static_cast<long long>(q_n) * rw;
  const unsigned pack_blocks = static_cast<unsigned>((words + 255) / 256);
  const bool vec =
      r_n % 16 == 0 && reinterpret_cast<uintptr_t>(frontier) % 16 == 0;
  const int wblocks = (w_n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long cols = static_cast<long long>(wblocks) * q_n;
  const int groups = (q_n + GROUP - 1) / GROUP;
  const int sms = sm_count();
  if (!PARENTS && q_n >= GROUP &&
      static_cast<long long>(groups) * wblocks >= sms) {
    if (rw > 0)
      pack_frontier<true><<<pack_blocks, 256, 0, stream>>>(
          static_cast<const uint8_t*>(frontier), q_n, r_n, rw, vec,
          static_cast<uint32_t*>(fw));
    push_group<<<dim3(wblocks, groups), SCAN_THREADS * SUBS, 0, stream>>>(
        static_cast<const uint32_t*>(fw), rw, q_n,
        static_cast<const uint32_t*>(adj), w_n, v_n,
        static_cast<const uint8_t*>(alive),
        static_cast<const uint8_t*>(visited), static_cast<uint8_t*>(new_out),
        static_cast<uint32_t*>(reach));
    return cudaGetLastError();
  }
  if (rw > 0)
    pack_frontier<false><<<pack_blocks, 256, 0, stream>>>(
        static_cast<const uint8_t*>(frontier), q_n, r_n, rw, vec,
        static_cast<uint32_t*>(fw));
  const long long np = PARENTS ? static_cast<long long>(q_n) * v_n : 0;
  const long long nr = static_cast<long long>(q_n) * w_n;
  init_outputs<<<static_cast<unsigned>(
                     std::min(4096LL, (std::max(np, nr) + 255) / 256)),
                 256, 0, stream>>>(static_cast<int32_t*>(parent), np,
                                   static_cast<uint32_t*>(reach), nr);
  // at most SPLIT_WORDS frontier words (32 rows each) a block, and at
  // least MIN_BLOCKS blocks
  long long splits = std::max((MIN_BLOCKS + cols - 1) / cols,
                              static_cast<long long>(
                                  (rw + SPLIT_WORDS - 1) / SPLIT_WORDS));
  splits = std::max(1LL, std::min(splits, static_cast<long long>(rw)));
  const int words_per_split = static_cast<int>((rw + splits - 1) / splits);
  const int n_split = std::max(1, (rw + words_per_split - 1) /
                                      std::max(1, words_per_split));
  push_scan<PARENTS><<<dim3(wblocks, q_n, n_split), SCAN_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(fw), rw, static_cast<const uint32_t*>(adj),
      w_n, v_n, words_per_split * 32, static_cast<int32_t*>(parent),
      static_cast<uint32_t*>(reach));
  push_epilogue<PARENTS><<<dim3((v_n + 255) / 256, q_n), 256, 0, stream>>>(
      static_cast<const uint32_t*>(reach), w_n,
      static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(visited), v_n,
      static_cast<uint8_t*>(new_out), static_cast<int32_t*>(parent));
  return cudaGetLastError();
}

inline cudaError_t launch(const void* frontier, const void* adj,
                          const void* alive, const void* visited,
                          void* new_out, void* parent, void* reach, void* fw,
                          int q_n, int r_n, int w_n, int v_n, int parents,
                          cudaStream_t stream) {
  if (q_n <= 0 || v_n <= 0) return cudaSuccess;
  return parents ? launch_impl<true>(frontier, adj, alive, visited, new_out,
                                     parent, reach, fw, q_n, r_n, w_n, v_n,
                                     stream)
                 : launch_impl<false>(frontier, adj, alive, visited, new_out,
                                      parent, reach, fw, q_n, r_n, w_n, v_n,
                                      stream);
}

}  // namespace push

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
