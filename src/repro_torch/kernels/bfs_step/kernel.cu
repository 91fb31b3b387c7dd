// B3: one packed top-down BFS superstep for a single frontier, and B7: its
// dense form over a uint8 adjacency, on sm_90a.
// B3 replaces repro/kernels/bfs_step/kernel.py::bfs_step_packed_pallas.
// B7 replaces repro/kernels/bfs_step/kernel.py::bfs_step_pallas, the Q = 1
// instance of the B6 dense push (../bfs_multi_step/dense.cuh).
//
// B3's contract (bool = one byte, words = int32 bit patterns read as
// uint32):
//   frontier bool[V]   adj int32[V, W]   alive bool[V]   visited bool[V]
//   -> reach int32[W]  raw OR of the active rows' words (no liveness mask)
//      parent int32[V] smallest active row with bit c set, where new; -1
//                      elsewhere
//      new bool[V]     reach & alive & !visited
//
// What bounds it: the bytes of the active rows (|frontier| * W * 4, each
// row once) and the V bytes of frontier, alive, visited and new and 4 V of
// parent: 0.775 us at the Graph500 cell's phase-6 launches, below what
// one launch of any kernel takes. So the design spends as few launches and
// dependent round trips to memory as it can:
//   * push_single, ONE launch: a block per 16-word (512-column) slice of
//     the adjacency, over ALL active rows, so no row split, no global
//     atomic, no init and no epilogue pass (136 blocks at W = 2,176).
//   * The blocks find the active rows themselves, 8 to a thread block
//     cluster: each block packs 1/8 of the bool frontier (320 words of 32
//     rows, two 16-byte loads a word, all issued before any is used) into
//     its shared memory; after a cluster barrier every block reads the 8
//     shares through distributed shared memory, counts the set rows, and a
//     block scan places them in a shared row list (4,096 rows a round; a
//     larger frontier takes more rounds, V > 81,920 more passes). Blocks
//     that each read the whole 69,632-byte frontier, and a second launch
//     (one block listing the rows in global memory first), ran slower on
//     an H100; the alive and visited bytes of a thread's two columns are
//     loaded at the start, so their round trip hides under the frontier's.
//   * 4 lanes own a row's 16 words (16 bytes each, one 64-byte segment), so
//     a warp reads 8 rows at once and a block 64, 8 rows in flight a lane:
//     512 row loads in flight a block, one round trip for most of the
//     cell's frontiers. (16 rows in flight spilled registers; blocks of
//     512 threads fit one to an SM, and clusters of 8 such blocks no
//     longer all fit at once: both ran slower.)
//   * Every set bit records its row with a shared atomicMin: the list is in
//     no particular order, and the min does not depend on it, so the
//     parent is the smallest row on every run. Rows are sparse (16 edges
//     in 69,632 columns a row on the cell), so records are few; an
//     ascending list with a record only for a lane's first row to set a
//     needed (alive, unvisited) column ran slower on an H100 (the order
//     and the mask cost more than the records they save).
//   * The words are ORed in registers, then across the lanes of a word and
//     the block's warps (shared atomicOr); the block writes reach, and new
//     (a set bit of an alive, unvisited column) and parent (its record;
//     -1 elsewhere) for its columns once, coalesced.
#include <cooperative_groups.h>

#include "../bfs_multi_step/dense.cuh"
#include "../bfs_multi_step/push.cuh"

namespace single {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = 16;                  // adjacency words a block owns
constexpr int COLS = SLICE * 32;           // its columns (512)
constexpr int QUADS = SLICE / 4;           // lanes sharing a row (16 B each)
constexpr int ROWS_AT_ONCE = THREADS / QUADS;  // rows a block loads at once
constexpr int UNROLL = 8;                  // rows in flight a lane
constexpr int CLUSTER = 8;                 // blocks that share a frontier read
constexpr int SHARE = 320;                 // frontier words a block packs a pass
constexpr int PASS = CLUSTER * SHARE;      // words a pass lists (81,920 rows)
constexpr int PACK = PASS / THREADS;       // pass words a thread counts (10)
constexpr int LIST = 4096;                 // rows of a shared list round
constexpr int32_t NO_PARENT = 0x7fffffff;

static_assert(COLS == 2 * THREADS, "a thread finishes two columns");
static_assert(PASS % THREADS == 0 && SHARE <= 2 * THREADS,
              "a pass's words spread evenly; a thread packs two words");

// Bits of the 32 frontier bytes of a 16-byte aligned word (two loads)
__device__ __forceinline__ uint32_t word_bits(uint4 a, uint4 b) {
  return push::nonzero_bytes(a.x) | push::nonzero_bytes(a.y) << 4 |
         push::nonzero_bytes(a.z) << 8 | push::nonzero_bytes(a.w) << 12 |
         push::nonzero_bytes(b.x) << 16 | push::nonzero_bytes(b.y) << 20 |
         push::nonzero_bytes(b.z) << 24 | push::nonzero_bytes(b.w) << 28;
}

// Bits of frontier rows 32w.. that exist (rows >= v_n are not set), byte by
// byte: the ragged last word, or a frontier that is not 16-byte aligned
__device__ __forceinline__ uint32_t word_bits_bytewise(const uint8_t* f,
                                                       int w, int v_n) {
  const uint8_t* p = f + (static_cast<size_t>(w) << 5);
  uint32_t m = 0u;
  for (int k = 0; k < 32 && (w << 5) + k < v_n; ++k)
    if (p[k]) m |= 1u << k;
  return m;
}

// Exclusive prefix of ``x`` over the block's threads, and the block's sum.
// ``warp_sum`` holds WARPS ints; the call ends on a barrier.
__device__ __forceinline__ int block_scan(int x, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    before += i < warp ? warp_sum[i] : 0;
    all += warp_sum[i];
  }
  *total = all;
  __syncthreads();  // warp_sum may be written again
  return before + incl - x;
}

// Word k of this thread's PACK words from ``cb`` (strided over the block's
// threads: coalesced reads)
__device__ __forceinline__ int word_of(int cb, int k) {
  return cb + k * THREADS + static_cast<int>(threadIdx.x);
}

// The rows of m[] (words word_of(cb, k)) at positions pos = off,
// off + 1, ... that fall in [lo, lo + n): out[pos - lo] = row
__device__ __forceinline__ void emit_rows(const uint32_t* m, int cb, int off,
                                          int cnt, int lo, int n,
                                          int32_t* out) {
  if (off >= lo + n || off + cnt <= lo) return;
  int pos = off;
#pragma unroll
  for (int k = 0; k < PACK; ++k) {
    const int rbase = word_of(cb, k) << 5;
    for (uint32_t bits = m[k]; bits; bits &= bits - 1, ++pos)
      if (pos >= lo && pos < lo + n) out[pos - lo] = rbase + __ffs(bits) - 1;
  }
}

// 16 bytes of row ``row`` from word ``w``: words >= w_n read as 0; vec:
// every row starts 16-byte aligned (W % 4 == 0, adj aligned)
__device__ __forceinline__ uint4 load_words(const uint32_t* adj, int row,
                                            int w_n, int w, bool vec) {
  const uint32_t* p = adj + static_cast<size_t>(row) * w_n + w;
  if (vec) return w < w_n ? __ldg(reinterpret_cast<const uint4*>(p))
                          : make_uint4(0u, 0u, 0u, 0u);
  uint4 a;
  a.x = w < w_n ? __ldg(p) : 0u;
  a.y = w + 1 < w_n ? __ldg(p + 1) : 0u;
  a.z = w + 2 < w_n ? __ldg(p + 2) : 0u;
  a.w = w + 3 < w_n ? __ldg(p + 3) : 0u;
  return a;
}

// Record ``row`` as a first-hit candidate of every column ``x`` sets in
// word j of this lane's quad (shared atomicMin: the order does not matter;
// the epilogue keeps the record only where the column is new)
__device__ __forceinline__ void record(uint32_t x, int j, int row,
                                       int32_t* par_s) {
  for (; x; x &= x - 1) atomicMin(&par_s[(j << 5) + __ffs(x) - 1], row);
}

struct Block {  // shared state of one push block
  int32_t list[LIST];
  int32_t par[COLS];
  uint32_t acc[SLICE];
  uint32_t share[SHARE];  // this block's packed words of the pass
  int warp_sum[WARPS];
};

// Walk list[0, n): ORs the rows' words of this lane's quad into acc and
// records each row against the columns it sets
__device__ __forceinline__ void walk(const Block& s, int n,
                                     const uint32_t* adj, int w_n, int w0,
                                     bool vec, int32_t* par_s, uint4& acc) {
  const int quad = threadIdx.x % QUADS;
  const int w = w0 + quad * 4;
  const int j0 = quad * 4;
  for (int i0 = threadIdx.x / QUADS; i0 < n; i0 += ROWS_AT_ONCE * UNROLL) {
    int rows[UNROLL];
    uint4 a[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * ROWS_AT_ONCE;
      rows[u] = i < n ? s.list[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      a[u] = rows[u] >= 0 ? load_words(adj, rows[u], w_n, w, vec)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc.x |= a[u].x;
      acc.y |= a[u].y;
      acc.z |= a[u].z;
      acc.w |= a[u].w;
      if (a[u].x | a[u].y | a[u].z | a[u].w) {
        record(a[u].x, j0, rows[u], par_s);
        record(a[u].y, j0 + 1, rows[u], par_s);
        record(a[u].z, j0 + 2, rows[u], par_s);
        record(a[u].w, j0 + 3, rows[u], par_s);
      }
    }
  }
}

// This block's SHARE words of the pass from ``base``, packed into
// s.share (all loads issued before any is used)
__device__ __forceinline__ void pack_share(const uint8_t* f, int base,
                                           unsigned rank, int rw, int v_n,
                                           bool vec, uint32_t* share) {
  uint4 lo[2], hi[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = k * THREADS + static_cast<int>(threadIdx.x);
    const int w = base + static_cast<int>(rank) * SHARE + j;
    const bool full = j < SHARE && vec && (w << 5) + 32 <= v_n;
    const uint4* p = reinterpret_cast<const uint4*>(
        f + (static_cast<size_t>(full ? w : 0) << 5));
    lo[k] = full ? __ldg(p) : make_uint4(0u, 0u, 0u, 0u);
    hi[k] = full ? __ldg(p + 1) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = k * THREADS + static_cast<int>(threadIdx.x);
    const int w = base + static_cast<int>(rank) * SHARE + j;
    if (j >= SHARE) continue;
    if (vec && (w << 5) + 32 <= v_n)
      share[j] = word_bits(lo[k], hi[k]);
    else
      share[j] = w < rw ? word_bits_bytewise(f, w, v_n) : 0u;
  }
}

// The two halves of a cluster barrier (cluster.sync() is both at once):
// arrive says this block's reads of the other blocks' shared memory are
// done; wait returns once every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid: x = 16-word slices of the adjacency, rounded up to whole clusters
// of CLUSTER blocks (a block past the last word only packs its share).
// The blocks of a cluster split each pass of the frontier read: each packs
// SHARE words into its shared memory, and after a cluster barrier every
// block reads all CLUSTER shares through distributed shared memory, so a
// block reads 1/CLUSTER of the frontier from L2 instead of all of it.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
push_single(const uint8_t* __restrict__ f, const uint32_t* __restrict__ adj,
            const uint8_t* __restrict__ alive,
            const uint8_t* __restrict__ visited, int v_n, int w_n, bool vec_f,
            bool vec_adj, uint8_t* __restrict__ new_out,
            int32_t* __restrict__ parent, uint32_t* __restrict__ reach) {
  __shared__ Block s;
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * SLICE;
  const int c0 = w0 << 5;
  for (int i = threadIdx.x; i < COLS; i += THREADS) s.par[i] = NO_PARENT;
  if (threadIdx.x < SLICE) s.acc[threadIdx.x] = 0u;
  // this thread's two columns' alive and visited bytes, loaded now (the
  // index clamped into range) and used last
  uint8_t al[2], vi[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = min(c0 + k * THREADS + static_cast<int>(threadIdx.x),
                      v_n - 1);
    al[k] = alive[c];
    vi[k] = visited[c];
  }
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int rw = (v_n + 31) / 32;
  for (int base = 0; base < rw; base += PASS) {
    pack_share(f, base, rank, rw, v_n, vec_f, s.share);
    cluster.sync();  // every share of the pass is packed
    uint32_t m[PACK];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < PACK; ++k) {
      const int j = word_of(0, k);  // coalesced remote reads
      m[k] = cluster.map_shared_rank(s.share, j / SHARE)[j % SHARE];
      cnt += __popc(m[k]);
    }
    // this block has read every share: it may be packed again (next
    // pass) or its block may exit once all have arrived (kernel end)
    cluster_arrive();
    if (base + PASS < rw) cluster_wait();  // cluster-uniform
    int total;
    const int off = block_scan(cnt, s.warp_sum, &total);
    if (w0 >= w_n) continue;  // block-uniform: no words of its own
    for (int lo = 0; lo < total; lo += LIST) {
      const int n = min(LIST, total - lo);
      emit_rows(m, base, off, cnt, lo, n, s.list);
      __syncthreads();
      walk(s, n, adj, w_n, w0, vec_adj, s.par, acc);
      __syncthreads();
    }
  }

  // OR the words over the lanes of a quad position, then over the warps
#pragma unroll
  for (int o = QUADS; o < 32; o <<= 1) {
    acc.x |= __shfl_xor_sync(FULL, acc.x, o);
    acc.y |= __shfl_xor_sync(FULL, acc.y, o);
    acc.z |= __shfl_xor_sync(FULL, acc.z, o);
    acc.w |= __shfl_xor_sync(FULL, acc.w, o);
  }
  if (lane < QUADS) {
    const int j0 = lane * 4;
    if (acc.x) atomicOr(&s.acc[j0], acc.x);
    if (acc.y) atomicOr(&s.acc[j0 + 1], acc.y);
    if (acc.z) atomicOr(&s.acc[j0 + 2], acc.z);
    if (acc.w) atomicOr(&s.acc[j0 + 3], acc.w);
  }
  __syncthreads();
  if (threadIdx.x < SLICE && w0 + static_cast<int>(threadIdx.x) < w_n)
    reach[w0 + threadIdx.x] = s.acc[threadIdx.x];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int cl = k * THREADS + static_cast<int>(threadIdx.x);
    const int c = c0 + cl;
    if (c >= v_n) continue;
    const bool is_new =
        al[k] && !vi[k] && (s.acc[cl >> 5] >> (cl & 31) & 1u);
    new_out[c] = is_new;
    parent[c] = is_new ? s.par[cl] : -1;
  }
  // no block exits while another may still read its share of the last
  // pass (waited here, not before the walk, so the wait overlaps it)
  cluster_wait();
}

cudaError_t launch(const void* frontier, const void* adj, const void* alive,
                   const void* visited, void* new_out, void* parent,
                   void* reach, int v_n, int w_n, cudaStream_t stream) {
  if (v_n <= 0) return cudaSuccess;
  const bool vec_f = reinterpret_cast<uintptr_t>(frontier) % 16 == 0;
  const bool vec_adj =
      w_n % 4 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0;
  const int slices = (w_n + SLICE - 1) / SLICE;
  const unsigned blocks =
      static_cast<unsigned>((slices + CLUSTER - 1) / CLUSTER * CLUSTER);
  push_single<<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(frontier), static_cast<const uint32_t*>(adj),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(visited),
      v_n, w_n, vec_f, vec_adj, static_cast<uint8_t*>(new_out),
      static_cast<int32_t*>(parent), static_cast<uint32_t*>(reach));
  return cudaGetLastError();
}

}  // namespace single

extern "C" int bfs_step_packed_launch(const void* frontier, const void* adj,
                                      const void* alive, const void* visited,
                                      void* new_out, void* parent, void* reach,
                                      int v_n, int w_n, void* stream) {
  return static_cast<int>(single::launch(
      frontier, adj, alive, visited, new_out, parent, reach, v_n, w_n,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int bfs_step_launch(const void* frontier, const void* adj,
                               const void* alive, const void* visited,
                               void* new_out, void* parent, void* qm,
                               void* scratch, int v_n, void* stream) {
  return static_cast<int>(dense::launch(frontier, adj, alive, visited,
                                        new_out, parent, qm, scratch, 1, v_n,
                                        v_n, 1,
                                        static_cast<cudaStream_t>(stream)));
}
