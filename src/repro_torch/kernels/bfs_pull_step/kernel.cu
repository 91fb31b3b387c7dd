// B2: one bottom-up ("pull") BFS superstep over R destination rows, on sm_90a.
// Replaces repro/kernels/bfs_pull_step/kernel.py::bfs_pull_step_pallas.
//
// Contract (bool = one byte, words = int32 bit patterns read as uint32):
//   fw int32[Q, W]  packed (frontier & alive) bitset per query
//   adj_in int32[R, W]  in-adjacency rows (R == V, or a row slice)
//   alive bool[R]   visited bool[Q, R]
//   -> new bool[Q, R]     hit & alive & !visited, hit = any(adj_in[r] & fw[q])
//      parent int32[Q, R] 32*w + ctz of the first nonzero adj_in[r,w] & fw[q,w]
//                         (a GLOBAL source id), where new; -1 elsewhere; not
//                         written when the caller asks for no parents
//
// What bounds it: the in-row words each pending row must read before its
// last pending query finds a parent (up to W * 4 bytes a row: an in-row
// with no hit is read to its end), plus the Q*R bytes of visited and the
// outputs. The earlier design (one warp per row, queries in series) was
// bound by latency instead: one dependent frontier load per query and
// in-row chunk, the row read again for every 64 queries, and one byte or
// int per query R apart. This one:
//   * transpose_frontier: fw -> fwT[W, Q] (query-contiguous) in 32x32
//     tiles, and in the same pass each query's "frontier non-empty" flag
//     and fany[w] = OR over the queries of fw[q, w]. Queries with an empty
//     frontier are never pending (the Pallas empty-frontier tile skip).
//   * pull_rows: a block owns a tile of 32 destination rows.
//     A. Each warp takes query groups of 32 (lane = query); a lane reads
//        its query's 32 visited bytes of the tile (two 16-byte loads):
//        the rows some query still has to visit. Dead rows and rows every
//        query has visited read no adjacency at all.
//     B. Each needed row is read ONCE, for all Q, with 16-byte loads (8
//        in flight a lane), masked by fany, and its nonzero words are
//        staged in shared memory as (word index, bits) pairs in ascending
//        order (a warp prefix sum places them). A row whose list does not
//        fit its warp's 256 entries (a hub's in-row: up to W = 2,176
//        words) is streamed from the adjacency again in phase C instead.
//     C. Each warp takes one query group (several warps split the rows
//        when Q < 256) and walks each row's list in ascending word order:
//        one coalesced load of fwT[w, 32 queries] per entry, 8 entries in
//        flight; a query's first nonzero a & fwT[w, q] gives 32*w + ctz,
//        the reference's minimum, and leaves the pending set. The row
//        ends when no query is pending or the list ends. Parents land in
//        a [rows x queries] shared tile that is written out transposed:
//        each query's 32 consecutive rows of new and parent in one
//        coalesced store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;             // destination rows per block
constexpr int LIST = 256;            // staged (word, bits) entries per warp
constexpr int MAX_WORDS = 65535;     // word indices are staged as uint16
constexpr int UNROLL = 8;            // 16-byte row loads in flight per lane
constexpr int WALK = 8;              // list entries walked per step

__global__ void __launch_bounds__(THREADS)
transpose_frontier(const uint32_t* __restrict__ fw, int q_n, int w_n,
                   uint32_t* __restrict__ fw_t, uint32_t* __restrict__ fany,
                   int* __restrict__ nonempty) {
  __shared__ uint32_t tile[32][33];
  const int w0 = blockIdx.x * 32, q0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += WARPS) {
    const int q = q0 + i, w = w0 + tx;
    const uint32_t x =
        (q < q_n && w < w_n) ? fw[static_cast<size_t>(q) * w_n + w] : 0u;
    tile[i][tx] = x;
    if (__any_sync(FULL, x != 0u) && tx == 0) nonempty[q] = 1;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += WARPS) {
    const int w = w0 + i, q = q0 + tx;
    const uint32_t x = tile[tx][i];
    if (w < w_n && q < q_n) fw_t[static_cast<size_t>(w) * q_n + q] = x;
    const uint32_t any = __reduce_or_sync(FULL, x);
    if (tx == 0 && any) atomicOr(fany + w, any);
  }
}

// Append this lane's N candidate words (ascending within the lane, lanes
// ascending) to a warp's list; returns the list's new length. Entries past
// ``cap`` are dropped (the caller then streams the row).
template <int N>
__device__ __forceinline__ int append(const uint32_t (&a)[N], int w_first,
                                      int n, int cap, uint16_t* lw,
                                      uint32_t* la) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) cnt += a[k] != 0u;
  if (!__any_sync(FULL, cnt != 0)) return n;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  int pos = n + incl - cnt;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (a[k] != 0u) {
      if (pos < cap) {
        lw[pos] = static_cast<uint16_t>(w_first + k);
        la[pos] = a[k];
      }
      ++pos;
    }
  }
  return n + __shfl_sync(FULL, incl, 31);
}

// Stage row ``arow``'s nonzero (word & fany) entries; returns the entry
// count, or -1 when they do not fit ``cap`` (the read stops there).
template <bool VEC>
__device__ int stage_row(const uint32_t* __restrict__ arow,
                         const uint32_t* __restrict__ fany, int w_n, int cap,
                         uint16_t* lw, uint32_t* la) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  if (VEC) {
    const uint4* a4 = reinterpret_cast<const uint4*>(arow);
    const uint4* f4 = reinterpret_cast<const uint4*>(fany);
    const int n4 = w_n >> 2;
    for (int b = 0; b < n4; b += 32 * UNROLL) {
      uint4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = b + u * 32 + lane;
        x[u] = i < n4 ? __ldg(a4 + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = b + u * 32 + lane;
        const uint4 f = i < n4 ? __ldg(f4 + i) : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t a[4] = {x[u].x & f.x, x[u].y & f.y, x[u].z & f.z,
                               x[u].w & f.w};
        n = append<4>(a, 4 * i, n, cap, lw, la);
      }
      if (n > cap) return -1;
    }
  } else {
    for (int b = 0; b < w_n; b += 32 * UNROLL) {
      uint32_t x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = b + u * 32 + lane;
        x[u] = i < w_n ? __ldg(arow + i) & __ldg(fany + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t a[1] = {x[u]};
        n = append<1>(a, b + u * 32 + lane, n, cap, lw, la);
      }
      if (n > cap) return -1;
    }
  }
  return n;
}

// The first source of query ``q`` (this lane) in a staged list, or -1.
__device__ __forceinline__ int walk_list(const uint16_t* lw,
                                         const uint32_t* la, int len,
                                         const uint32_t* __restrict__ fw_t,
                                         int q_n, int q, bool pend) {
  int p = -1;
  for (int e = 0; e < len; e += WALK) {
    int w[WALK];
    uint32_t a[WALK], f[WALK];
#pragma unroll
    for (int u = 0; u < WALK; ++u) {  // WALK frontier loads in flight
      const bool in = e + u < len;
      w[u] = in ? lw[e + u] : 0;
      a[u] = in ? la[e + u] : 0u;
      f[u] = (in && pend) ? __ldg(fw_t + static_cast<size_t>(w[u]) * q_n + q)
                          : 0u;
    }
#pragma unroll
    for (int u = 0; u < WALK; ++u) {
      const uint32_t c = a[u] & f[u];
      if (pend && c) {
        p = (w[u] << 5) + __ffs(c) - 1;
        pend = false;
      }
    }
    if (!__any_sync(FULL, pend)) break;
  }
  return p;
}

// The same walk over a row too long to stage, read from the adjacency.
__device__ int walk_row(const uint32_t* __restrict__ arow,
                        const uint32_t* __restrict__ fany, int w_n,
                        const uint32_t* __restrict__ fw_t, int q_n, int q,
                        bool pend) {
  const int lane = threadIdx.x & 31;
  int p = -1;
  for (int w0 = 0; w0 < w_n; w0 += 32) {
    const int w = w0 + lane;
    const uint32_t a = w < w_n ? __ldg(arow + w) & __ldg(fany + w) : 0u;
    unsigned nz = __ballot_sync(FULL, a != 0u);
    while (nz) {  // warp-uniform, ascending words
      const int j = __ffs(nz) - 1;
      nz &= nz - 1;
      const uint32_t aw = __shfl_sync(FULL, a, j);
      const uint32_t f =
          pend ? __ldg(fw_t + static_cast<size_t>(w0 + j) * q_n + q) : 0u;
      if (pend && (aw & f)) {
        p = ((w0 + j) << 5) + __ffs(aw & f) - 1;
        pend = false;
      }
      if (!__any_sync(FULL, pend)) return p;
    }
  }
  return p;
}

// Bit i set where byte i of ``x`` is nonzero (4 bits).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (x & 0xffu ? 1u : 0u) | (x & 0xff00u ? 2u : 0u) |
         (x & 0xff0000u ? 4u : 0u) | (x & 0xff000000u ? 8u : 0u);
}

// The mask of tile rows that this lane's query 32*g + lane still has to
// visit: its 32 visited bytes of the tile, two 16-byte loads when rows are
// 16-byte aligned (no load waits on another).
__device__ __forceinline__ uint32_t pending_rows(
    int g, uint32_t live_mask, int t0, int q_n, int r_n, bool vis16,
    const uint8_t* __restrict__ visited, const int* __restrict__ nonempty) {
  const int q = (g << 5) + (threadIdx.x & 31);
  if (!live_mask || q >= q_n || !nonempty[q]) return 0u;
  const uint8_t* v = visited + static_cast<size_t>(q) * r_n + t0;
  uint32_t vis = 0u;
  if (vis16 && t0 + 32 <= r_n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(v));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(v) + 1);
    vis = nonzero_bytes(a.x) | nonzero_bytes(a.y) << 4 |
          nonzero_bytes(a.z) << 8 | nonzero_bytes(a.w) << 12 |
          nonzero_bytes(b.x) << 16 | nonzero_bytes(b.y) << 20 |
          nonzero_bytes(b.z) << 24 | nonzero_bytes(b.w) << 28;
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (t0 + k < r_n && v[k]) vis |= 1u << k;
  }
  return live_mask & ~vis;
}

template <bool VEC, bool PARENTS>
__global__ void __launch_bounds__(THREADS, 4)  // 4 blocks fit shared memory
pull_rows(const uint32_t* __restrict__ fw_t, const uint32_t* __restrict__ fany,
          const int* __restrict__ nonempty,
          const uint32_t* __restrict__ adj_in,
          const uint8_t* __restrict__ alive,
          const uint8_t* __restrict__ visited, int q_n, int r_n, int w_n,
          bool vis16, uint8_t* __restrict__ new_out,
          int32_t* __restrict__ parent) {
  __shared__ int32_t par_s[WARPS][TILE][TILE + 1];  // [group][row][query]
  __shared__ uint32_t la_s[WARPS * LIST];
  __shared__ uint16_t lw_s[WARPS * LIST];
  __shared__ int start_s[TILE], len_s[TILE];
  __shared__ uint32_t needed_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * TILE;
  const int row = t0 + lane;  // lane j stands for tile row j
  // bit j: tile row j is alive (the same in every warp)
  const uint32_t live_mask = __ballot_sync(FULL, row < r_n && alive[row]);
  const int groups = (q_n + 31) >> 5;
  if (threadIdx.x == 0) needed_s = 0u;
  __syncthreads();

  // A. the rows some query still has to visit
  if (live_mask) {
    for (int g = warp; g < groups; g += WARPS) {
      const uint32_t any = __reduce_or_sync(
          FULL, pending_rows(g, live_mask, t0, q_n, r_n, vis16, visited,
                             nonempty));
      if (lane == 0 && any) atomicOr(&needed_s, any);
    }
  }
  __syncthreads();
  const uint32_t needed = needed_s;

  // B. each needed row's nonzero words, staged once for every query
  {
    int used = 0;
    uint16_t* lw = lw_s + warp * LIST;
    uint32_t* la = la_s + warp * LIST;
    for (int k = warp; k < TILE; k += WARPS) {
      int n = 0;
      if ((needed >> k) & 1u) {
        const uint32_t* arow = adj_in + static_cast<size_t>(t0 + k) * w_n;
        n = stage_row<VEC>(arow, fany, w_n, LIST - used, lw + used,
                           la + used);
      }
      if (lane == 0) {
        start_s[k] = warp * LIST + used;
        len_s[k] = n;
      }
      if (n > 0) used += n;
    }
  }
  __syncthreads();

  // C. per query group: walk the lists, then write the tile transposed
  for (int gb = 0; gb < groups; gb += WARPS) {
    const int gn = min(WARPS, groups - gb);
    const int per = WARPS / gn;  // warps per group; they split the rows
    const int gs = warp % gn, sub = warp / gn;
    if (sub < per) {
      const int q = ((gb + gs) << 5) + lane;
      const uint32_t mine =
          needed ? pending_rows(gb + gs, live_mask, t0, q_n, r_n, vis16,
                                visited, nonempty)
                 : 0u;
      for (int k = sub; k < TILE; k += per) {
        const bool pend = (mine >> k) & 1u;
        int p = -1;
        if (__any_sync(FULL, pend)) {
          const int len = len_s[k];
          p = len >= 0
                  ? walk_list(lw_s + start_s[k], la_s + start_s[k], len,
                              fw_t, q_n, q, pend)
                  : walk_row(adj_in + static_cast<size_t>(t0 + k) * w_n,
                             fany, w_n, fw_t, q_n, q, pend);
        }
        par_s[gs][k][lane] = p;
      }
    }
    __syncthreads();
    for (int i = warp; i < gn * 32; i += WARPS) {  // (group slot, query)
      const int q = (gb << 5) + i;
      if (q < q_n && row < r_n) {
        const int32_t p = par_s[i >> 5][lane][i & 31];
        const size_t o = static_cast<size_t>(q) * r_n + row;
        new_out[o] = p >= 0;
        if (PARENTS) parent[o] = p;
      }
    }
    __syncthreads();
  }
}

template <bool VEC, bool PARENTS>
void launch_rows(dim3 grid, cudaStream_t s, const uint32_t* fw_t,
                 const uint32_t* fany, const int* nonempty,
                 const void* adj_in, const void* alive, const void* visited,
                 int q_n, int r_n, int w_n, void* new_out, void* parent) {
  const bool vis16 =
      r_n % 16 == 0 && reinterpret_cast<uintptr_t>(visited) % 16 == 0;
  pull_rows<VEC, PARENTS><<<grid, THREADS, 0, s>>>(
      fw_t, fany, nonempty, static_cast<const uint32_t*>(adj_in),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(visited),
      q_n, r_n, w_n, vis16, static_cast<uint8_t*>(new_out),
      static_cast<int32_t*>(parent));
}

}  // namespace

// scratch: int32[W + Q + W * Q] (fany, nonempty, fwT); parent may be null
// when ``parents`` is 0.
extern "C" int bfs_pull_step_launch(const void* fw, const void* adj_in,
                                    const void* alive, const void* visited,
                                    void* new_out, void* parent,
                                    void* scratch, int q_n, int r_n, int w_n,
                                    int parents, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_n <= 0 || r_n <= 0) return 0;
  if (w_n <= 0 || w_n > MAX_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* fany = static_cast<uint32_t*>(scratch);
  int* nonempty = reinterpret_cast<int*>(fany + w_n);
  uint32_t* fw_t = reinterpret_cast<uint32_t*>(nonempty + q_n);
  cudaError_t err = cudaMemsetAsync(
      fany, 0, sizeof(uint32_t) * (static_cast<size_t>(w_n) + q_n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  transpose_frontier<<<dim3((w_n + 31) / 32, (q_n + 31) / 32), THREADS, 0,
                       s>>>(static_cast<const uint32_t*>(fw), q_n, w_n, fw_t,
                            fany, nonempty);
  const bool vec = w_n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(adj_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(fany) % 16 == 0;
  const dim3 grid((r_n + TILE - 1) / TILE);
  if (vec && parents)
    launch_rows<true, true>(grid, s, fw_t, fany, nonempty, adj_in, alive,
                            visited, q_n, r_n, w_n, new_out, parent);
  else if (vec)
    launch_rows<true, false>(grid, s, fw_t, fany, nonempty, adj_in, alive,
                             visited, q_n, r_n, w_n, new_out, parent);
  else if (parents)
    launch_rows<false, true>(grid, s, fw_t, fany, nonempty, adj_in, alive,
                             visited, q_n, r_n, w_n, new_out, parent);
  else
    launch_rows<false, false>(grid, s, fw_t, fany, nonempty, adj_in, alive,
                              visited, q_n, r_n, w_n, new_out, parent);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
