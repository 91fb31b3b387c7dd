// B2: one bottom-up ("pull") BFS superstep over R destination rows, on sm_90a.
// Replaces repro/kernels/bfs_pull_step/kernel.py::bfs_pull_step_pallas.
//
// Contract (bool = one byte, words = int32 bit patterns read as uint32):
//   fw int32[Q, W]  packed (frontier & alive) bitset per query
//   adj_in int32[R, W]  in-adjacency rows (R == V, or a row slice)
//   alive bool[R]   visited bool[Q, R]
//   -> new bool[Q, R]     hit & alive & !visited, hit = any(adj_in[r] & fw[q])
//      parent int32[Q, R] 32*w + ctz of the first nonzero adj_in[r,w] & fw[q,w]
//                         (a GLOBAL source id), where new; -1 elsewhere
//
// What bounds it: the in-row words each pending row must read before its
// last pending query finds a parent (at most W * 4 bytes a row), plus the
// Q*R bytes of visited and outputs. The design:
//   * one warp per destination row; dead rows and rows every query has
//     visited read no adjacency at all;
//   * the warp reads its row 32 words (128 bytes) at a time, coalesced, and
//     skips a chunk with no in-edges in one ballot;
//   * within a chunk each still-pending query ANDs its frontier words; the
//     lowest lane with a nonzero word (__ffs of the ballot) and the lowest
//     bit in it (__ffs) give the smallest source, and the query leaves the
//     pending set: the scan stops at the first hit, per query;
//   * queries with an empty frontier are never pending (frontier_nonempty),
//     the counterpart of the Pallas empty-frontier tile skip.
// Queries are handled 64 at a time (one 64-bit pending mask).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;

__global__ void frontier_nonempty(const uint32_t* __restrict__ fw, int w_n,
                                  int* __restrict__ nonempty) {
  const uint32_t* row = fw + static_cast<size_t>(blockIdx.x) * w_n;
  int any = 0;
  for (int w = threadIdx.x; w < w_n && !any; w += blockDim.x)
    any = row[w] != 0u;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) nonempty[blockIdx.x] = any;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
pull_rows(const uint32_t* __restrict__ fw, const uint32_t* __restrict__ adj_in,
          const uint8_t* __restrict__ alive,
          const uint8_t* __restrict__ visited,
          const int* __restrict__ nonempty, int q_n, int r_n, int w_n,
          uint8_t* __restrict__ new_out, int32_t* __restrict__ parent) {
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= r_n) return;  // whole warp
  const bool live = alive[row] != 0;
  const uint32_t* arow = adj_in + static_cast<size_t>(row) * w_n;

  for (int q0 = 0; q0 < q_n; q0 += 64) {
    const int nq = min(64, q_n - q0);
    const int qa = q0 + lane, qb = q0 + 32 + lane;
    const bool pa = live && lane < nq &&
                    !visited[static_cast<size_t>(qa) * r_n + row] &&
                    nonempty[qa];
    const bool pb = live && lane + 32 < nq &&
                    !visited[static_cast<size_t>(qb) * r_n + row] &&
                    nonempty[qb];
    uint64_t pending = __ballot_sync(FULL, pa) |
                       (static_cast<uint64_t>(__ballot_sync(FULL, pb)) << 32);
    int par_a = -1, par_b = -1;  // lane j holds queries q0 + j, q0 + 32 + j

    for (int w0 = 0; w0 < w_n && pending; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t a = w < w_n ? arow[w] : 0u;
      if (!__ballot_sync(FULL, a != 0u)) continue;  // no in-edges here
      uint64_t todo = pending;
      while (todo) {  // warp-uniform
        const int j = __ffsll(static_cast<long long>(todo)) - 1;
        todo &= todo - 1;
        const uint32_t c =
            a ? a & fw[static_cast<size_t>(q0 + j) * w_n + w] : 0u;
        const unsigned hit = __ballot_sync(FULL, c != 0u);
        if (hit) {
          const int src = __ffs(hit) - 1;
          const uint32_t cw = __shfl_sync(FULL, c, src);
          const int p = ((w0 + src) << 5) + __ffs(cw) - 1;
          if (lane == (j & 31)) {
            if (j < 32) par_a = p; else par_b = p;
          }
          pending &= ~(1ull << j);
        }
      }
    }
    if (lane < nq) {
      const size_t i = static_cast<size_t>(qa) * r_n + row;
      new_out[i] = par_a >= 0;
      parent[i] = par_a;
    }
    if (lane + 32 < nq) {
      const size_t i = static_cast<size_t>(qb) * r_n + row;
      new_out[i] = par_b >= 0;
      parent[i] = par_b;
    }
  }
}

}  // namespace

extern "C" int bfs_pull_step_launch(const void* fw, const void* adj_in,
                                    const void* alive, const void* visited,
                                    void* new_out, void* parent,
                                    void* nonempty, int q_n, int r_n, int w_n,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_n <= 0 || r_n <= 0) return 0;
  frontier_nonempty<<<q_n, 256, 0, s>>>(static_cast<const uint32_t*>(fw), w_n,
                                        static_cast<int*>(nonempty));
  const int blocks = (r_n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  pull_rows<<<blocks, WARPS_PER_BLOCK * 32, 0, s>>>(
      static_cast<const uint32_t*>(fw), static_cast<const uint32_t*>(adj_in),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(visited),
      static_cast<const int*>(nonempty), q_n, r_n, w_n,
      static_cast<uint8_t*>(new_out), static_cast<int32_t*>(parent));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
