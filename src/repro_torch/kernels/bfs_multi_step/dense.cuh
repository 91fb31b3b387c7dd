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
//                         slice) with adj[r, c] != 0, where new; -1
//                         elsewhere; not written when the caller asks for
//                         no parents (closure mode)
//
// What bounds it: bytes. The active rows (|union of a query group's
// frontier rows| * V, each row read once per group of 64 queries) plus the
// Q*V bytes of frontier, visited and new and the 4*Q*V of parent. The
// Pallas kernel feeds the MXU a [Q, R] @ [R, V] product; here the reach
// needs no product at all, because a hit is exactly a row that sets a
// parent, and the view is 0.02% ones: an int8 tensor-core product would
// replace a zero test that costs nothing once the loads are 16 bytes, and
// would give counts, not the smallest row. The design:
//   1. dense_masks: a thread per row, per group of 64 queries: a uint64
//      query mask (bit j: the row is in query 64g + j's frontier), a
//      ballot word per 32 rows and an active-row count per 256 rows.
//   2. dense_compact: the ascending list of each group's active rows (each
//      block adds the counts of the blocks before it), so the walk reads a
//      list it can prefetch instead of ballot words.
//   3. dense_push: one block per 256-column slice of one group, over ALL
//      of the group's active rows: no row split, so no global atomic and
//      no init or epilogue pass. The block first reads its slice of
//      visited into ``need`` (a uint64 per column: the queries for which
//      the column is alive and unvisited); a lane starts its ``found``
//      masks (a uint64 per column, in registers) at ~need, so visited and
//      dead columns cost nothing and a lane whose 16 columns nobody needs
//      loads nothing. 16 lanes own a row's slice, 16 bytes each (one
//      coalesced 256-byte segment); the block's 16 such walkers take rows
//      i, i + 16, ... of the list, 4 rows in flight each (8 without
//      parents), the next rows' list entries loaded under them. An all-zero
//      16-byte chunk costs one compare; a nonzero byte loads the row's
//      query mask, and the queries it reaches first for this lane are
//      recorded with a shared-memory atomic min on a [64 x 256] int32
//      tile: each walker walks ascending rows, so its first hit is its
//      smallest, and the min over walkers is the smallest, whatever their
//      order. Then the block writes new (a recorded hit) and parent (-1
//      elsewhere) once, coalesced per query row. Without parents the tile
//      is a uint64 hit mask per column, ORed once per lane at the end, and
//      only new is written.
// At V = 69,632 a group has 272 slices: with parents 3 blocks an SM fit
// (66 KB of shared memory each), so they run in one wave on 132 SMs.
#pragma once

#include "push.cuh"

namespace dense {

constexpr int GROUP = 64;                    // queries per uint64 mask
constexpr int MASK_ROWS = 256;               // rows of a mask / compact block
constexpr int SLICE = 256;                   // columns a push block owns
constexpr int CHUNK = 16;                    // bytes a lane loads at once
constexpr int WALKER = SLICE / CHUNK;        // lanes that share a row (16)
constexpr int PUSH_THREADS = 256;
constexpr int WALKERS = PUSH_THREADS / WALKER;  // rows a block walks at once
// rows in flight per walker: with parents the walk's record calls and the
// 3 blocks an SM that the 66 KB tile allows cap the registers at 80
template <bool PARENTS>
constexpr int UNROLL = PARENTS ? 4 : 8;

// grid: x = blocks of MASK_ROWS rows, y = query group; a row a thread.
// qm[g, r] = bit j: row r is in query 64g + j's frontier; act[g, w] = bit
// i: row 32w + i has a nonzero mask; bcnt[g, b] = block b's active rows.
__global__ void __launch_bounds__(MASK_ROWS)
dense_masks(const uint8_t* __restrict__ f, int q_n, int r_n, int rw,
            unsigned long long* __restrict__ qm, uint32_t* __restrict__ act,
            int* __restrict__ bcnt) {
  __shared__ int warp_cnt[MASK_ROWS / 32];
  const int g = blockIdx.y;
  const int r = blockIdx.x * MASK_ROWS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long m = 0ull;
  if (r < r_n) {
    const int q0 = g * GROUP, nq = min(GROUP, q_n - q0);
    const uint8_t* p = f + static_cast<size_t>(q0) * r_n + r;
#pragma unroll 8
    for (int j = 0; j < nq; ++j)
      if (p[static_cast<size_t>(j) * r_n]) m |= 1ull << j;
    qm[static_cast<size_t>(g) * r_n + r] = m;
  }
  const unsigned bits = __ballot_sync(push::FULL, m != 0ull);
  if (lane == 0) {
    if ((r >> 5) < rw) act[static_cast<size_t>(g) * rw + (r >> 5)] = bits;
    warp_cnt[warp] = __popc(bits);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int i = 0; i < MASK_ROWS / 32; ++i) t += warp_cnt[i];
    bcnt[static_cast<size_t>(g) * gridDim.x + blockIdx.x] = t;
  }
}

// grid: x = blocks of MASK_ROWS rows, y = query group; a warp per 32-row
// word. rows[g, 0..count[g]) = the group's active rows, ascending.
__global__ void __launch_bounds__(MASK_ROWS)
dense_compact(const uint32_t* __restrict__ act, const int* __restrict__ bcnt,
              int rw, int r_n, int* __restrict__ count,
              int* __restrict__ rows) {
  constexpr int WARPS = MASK_ROWS / 32;
  __shared__ int warp_off[WARPS];
  __shared__ int block_off;
  const int g = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* cnt = bcnt + static_cast<size_t>(g) * nb;
  const int w = b * WARPS + warp;
  const uint32_t word = w < rw ? act[static_cast<size_t>(g) * rw + w] : 0u;
  if (lane == 0) warp_off[warp] = __popc(word);
  if (warp == 0) {  // this block's offset: the active rows before it
    int s = 0;
    for (int i = lane; i < b; i += 32) s += cnt[i];
    s = __reduce_add_sync(push::FULL, s);
    if (lane == 0) block_off = s;
    if (lane == 0 && b == nb - 1) count[g] = s + cnt[b];
  }
  __syncthreads();
  int off = block_off;
  for (int i = 0; i < warp; ++i) off += warp_off[i];
  if ((word >> lane) & 1u)
    rows[static_cast<size_t>(g) * r_n + off +
         __popc(word & ((1u << lane) - 1u))] = (w << 5) + lane;
}

// 16 bytes of a row read once: no L1 allocation, the line is not reused
__device__ __forceinline__ uint4 load_stream(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// bytes c..c+15 of ``row``: one 16-byte load when rows are 16-byte aligned
// (then c + 16 <= v_n), else byte loads with the tail masked
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row,
                                        int c, int v_n, bool vec) {
  if (vec) return load_stream(row + c);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < CHUNK; ++k)
    if (c + k < v_n)
      w[k >> 2] |= static_cast<uint32_t>(__ldg(row + c + k)) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word_of(const uint4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// Row r is a candidate first hit of the queries in ``nb`` at the tile
// column at shared address ``cell`` (query 0's entry; queries are SLICE
// entries apart). Out of line: inlined into each (row, column) of the
// unrolled walk, the loop multiplies the kernel's code.
__device__ __noinline__ void record(uint32_t cell, unsigned long long nb,
                                    int r) {
  for (; nb; nb &= nb - 1) {
    const uint32_t q = __ffsll(static_cast<long long>(nb)) - 1;
    asm volatile("red.shared.min.s32 [%0], %1;"
                 :
                 : "r"(cell + q * SLICE * 4u), "r"(r)
                 : "memory");
  }
}

// grid: x = 256-column slices, y = query group. Shared memory: uint64
// need[SLICE] (bit j: query q0 + j may still reach the column: it is alive
// and unvisited), then with PARENTS int32 first[nq][SLICE] (nq = the
// group's queries), without uint64 hit[SLICE].
template <bool PARENTS>
__global__ void __launch_bounds__(PUSH_THREADS, PARENTS ? 3 : 2)
dense_push(const unsigned long long* __restrict__ qm,
           const int* __restrict__ count, const int* __restrict__ rows,
           const uint8_t* __restrict__ adj, int q_n, int r_n, int v_n,
           bool vec, const uint8_t* __restrict__ alive,
           const uint8_t* __restrict__ visited, uint8_t* __restrict__ new_out,
           int32_t* __restrict__ parent) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* need = reinterpret_cast<unsigned long long*>(smem);
  int32_t* first = reinterpret_cast<int32_t*>(need + SLICE);
  unsigned long long* hit = need + SLICE;
  const int g = blockIdx.y;
  const int q0 = g * GROUP;
  const int nq = min(GROUP, q_n - q0);
  const int c0 = blockIdx.x * SLICE;
  for (int t = threadIdx.x; t < SLICE; t += PUSH_THREADS) {  // a column
    const int c = c0 + t;
    unsigned long long nd = 0ull;
    if (c < v_n && alive[c]) {
      const uint8_t* vis = visited + static_cast<size_t>(q0) * v_n + c;
#pragma unroll 8
      for (int j = 0; j < nq; ++j)
        if (!vis[static_cast<size_t>(j) * v_n]) nd |= 1ull << j;
    }
    need[t] = nd;
    if (!PARENTS) hit[t] = 0ull;
  }
  if (PARENTS) {
    for (int i = threadIdx.x; i < nq * SLICE; i += PUSH_THREADS)
      first[i] = push::NO_PARENT;
  }
  __syncthreads();

  const int walker = threadIdx.x / WALKER;
  const int col = (threadIdx.x % WALKER) * CHUNK;  // this lane's, in slice
  const uint32_t tile =
      static_cast<uint32_t>(__cvta_generic_to_shared(first));
  const int cc = c0 + col;
  // found[k]: queries this lane has hit in column col + k, or that cannot
  // reach it (visited, or the column is dead)
  unsigned long long found[CHUNK];
  unsigned live = 0u;  // bit k: some query may still reach column col + k
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    found[k] = ~need[col + k];
    if (~found[k]) live |= 1u << k;
  }
  const int n = count[g];
  const int* grows = rows + static_cast<size_t>(g) * r_n;
  const unsigned long long* gqm = qm + static_cast<size_t>(g) * r_n;

  constexpr int U = UNROLL<PARENTS>;
  int r[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = walker + u * WALKERS;
    r[u] = j < n ? __ldg(grows + j) : -1;
  }
  for (int i = walker; i < n; i += WALKERS * U) {
    uint4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      a[u] = (live && r[u] >= 0)
                 ? load16(adj + static_cast<size_t>(r[u]) * v_n, cc, v_n, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
    int rn[U];  // the next rows, loaded while these are in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = i + (u + U) * WALKERS;
      rn[u] = j < n ? __ldg(grows + j) : -1;
    }
    unsigned long long m[U];  // the row's queries, where it hits
#pragma unroll
    for (int u = 0; u < U; ++u)
      m[u] = !(a[u].x | a[u].y | a[u].z | a[u].w) ? 0ull
             : q_n == 1                           ? 1ull
                                                  : __ldg(gqm + r[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {  // ascending rows: first hit = min
      if (!m[u]) continue;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        if (!((word_of(a[u], k >> 2) >> (8 * (k & 3))) & 0xffu)) continue;
        unsigned long long nb = m[u] & ~found[k];
        found[k] |= nb;
        if (PARENTS && nb) record(tile + (col + k) * 4u, nb, r[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = rn[u];
  }
  if (!PARENTS) {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const unsigned long long h = found[k] & need[col + k];
      if (h) atomicOr(hit + col + k, h);
    }
  }
  __syncthreads();

  // epilogue: new and parent of the slice, coalesced per query row; a
  // recorded hit is new (need held alive and unvisited)
  const int ncols = min(SLICE, v_n - c0);
  for (int i = threadIdx.x; i < nq * SLICE; i += PUSH_THREADS) {
    const int j = i / SLICE, c = i % SLICE;
    if (c >= ncols) continue;
    const size_t o = static_cast<size_t>(q0 + j) * v_n + c0 + c;
    if (PARENTS) {
      const int32_t p = first[i];
      new_out[o] = p != push::NO_PARENT;
      parent[o] = p != push::NO_PARENT ? p : -1;
    } else {
      new_out[o] = (hit[c] >> j) & 1ull;
    }
  }
}

// Scratch ints a launch needs beside qm uint64[groups, R]: the ballot
// words, the per-block counts, the list lengths and the row lists.
inline size_t scratch_ints(int groups, int r_n) {
  const size_t rw = (r_n + 31) / 32, nb = (r_n + MASK_ROWS - 1) / MASK_ROWS;
  return static_cast<size_t>(groups) * (rw + nb + 1 + r_n);
}

// The whole superstep on ``stream``. Scratch from the caller: qm
// uint64[ceil(Q/64), R] and int32[scratch_ints(ceil(Q/64), R)].
inline cudaError_t launch(const void* frontier, const void* adj,
                          const void* alive, const void* visited,
                          void* new_out, void* parent, void* qm, void* scratch,
                          int q_n, int r_n, int v_n, int parents,
                          cudaStream_t stream) {
  if (q_n <= 0 || v_n <= 0) return cudaSuccess;
  const int groups = (q_n + GROUP - 1) / GROUP;
  const int rw = (r_n + 31) / 32;
  const int nb = (r_n + MASK_ROWS - 1) / MASK_ROWS;
  uint32_t* act = static_cast<uint32_t*>(scratch);
  int* bcnt = reinterpret_cast<int*>(act + static_cast<size_t>(groups) * rw);
  int* count = bcnt + static_cast<size_t>(groups) * nb;
  int* rows = count + groups;
  auto* masks = static_cast<unsigned long long*>(qm);
  if (nb > 0) {
    dense_masks<<<dim3(nb, groups), MASK_ROWS, 0, stream>>>(
        static_cast<const uint8_t*>(frontier), q_n, r_n, rw, masks, act,
        bcnt);
    dense_compact<<<dim3(nb, groups), MASK_ROWS, 0, stream>>>(
        act, bcnt, rw, r_n, count, rows);
  } else {
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * groups, stream);
    if (err != cudaSuccess) return err;
  }
  const bool vec =
      v_n % CHUNK == 0 && reinterpret_cast<uintptr_t>(adj) % CHUNK == 0;
  const dim3 grid((v_n + SLICE - 1) / SLICE, groups);
  const auto* a8 = static_cast<const uint8_t*>(adj);
  const auto* al = static_cast<const uint8_t*>(alive);
  const auto* vis = static_cast<const uint8_t*>(visited);
  auto* nw = static_cast<uint8_t*>(new_out);
  if (parents) {
    const int shm = SLICE * 8 + std::min(q_n, GROUP) * SLICE * 4;
    cudaError_t err = cudaFuncSetAttribute(
        dense_push<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dense_push<true>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    dense_push<true><<<grid, PUSH_THREADS, shm, stream>>>(
        masks, count, rows, a8, q_n, r_n, v_n, vec, al, vis, nw,
        static_cast<int32_t*>(parent));
  } else {
    dense_push<false><<<grid, PUSH_THREADS, SLICE * 16, stream>>>(
        masks, count, rows, a8, q_n, r_n, v_n, vec, al, vis, nw, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace dense
