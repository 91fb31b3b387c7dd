// The serial correction pass of apply_ops_fast, on sm_90a: the batch's
// conflicting lanes (every lane, when its AddVertex lanes overflow the free
// slots) applied to its state copy in lane order, in place, in one launch.
// Replaces no Pallas kernel: the JAX package runs this pass as a
// lax.fori_loop over the masked lanes (repro/core/ops.py::_serial_masked),
// and the port's plain version is the host pass, _SerialPass in
// serial_pass/ref.py, which this kernel matches bit for bit.
//
// Contract (in place; the caller passes the batch's copy of the state):
//   vkey int32[V]  valive bool[V]  vver int32[V]  ecnt int32[V]
//   adj, adj_in int32[V, W]   the out- and in-edge mirrors, bit c % 32 of
//                             word c / 32 of row r is the arc r -> c (adj)
//                             and c -> r (adj_in)
//   opcode, key1, key2, expect int32[B]  mask bool[B]   the batch
//   res int32[B]   the result code of every lane with mask set is written
//                  (out-of-range opcodes clip to [OP_NOP, OP_CON_E]); the
//                  other lanes' entries are left as they are
//   scratch int32[SCRATCH_INTS], zeroed by the caller
// A lane is the host pass's apply_one: find(k) is the lowest slot with
// vkey == k and valive set (so a negative key finds only a slot that an
// AddVertex of that key made alive), the free slot the lowest slot whose
// vkey is EMPTY_KEY; a RemoveVertex reads its live in-sources before it
// marks the vertex dead (a self-loop bumps its own ecnt twice); ecnt and
// vver wrap as int32. Offsets into the mirrors are 64-bit (V * W passes
// 2^31 at V = 266,240).
//
// What bounds it: latency. Lanes depend on each other through the slot
// table, so they run one after another, and a lane's work is small: a
// lookup over the table (5 bytes a slot: 1.3 MB at V = 266,240, which the
// L2 keeps), a sweep of one in-row (4 W bytes) for a RemoveVertex, one row
// and one word of every row of both mirrors (2 V sectors) for an
// AddVertex, a few words for an edge op. One block would take ~10 us a
// lane for the lookup alone and ~0.3 ms for an AddVertex's column, so
// the design is a persistent grid of one block an SM (a cooperative
// launch, so that all are resident) that walks the lanes together:
//   * every block reads the mask and the lane's fields itself; control
//     flow is the same in every block;
//   * a lane's lookups are split by slot: block b scans its own slice of
//     the table for find(key1), find(key2) and the free slot at once, a
//     block reduction keeps its lowest hits, and one atomicMax of V - slot
//     a lookup publishes them (0 is "none", which a zeroed scratch means);
//   * one grid barrier a lane, after the lookups: from there every block
//     knows the lane's slots and takes its share of the lane's writes
//     (the in-row sweep, the row and column of the scrub) by a grid-wide
//     stride; a single-word op runs in one thread;
//   * the slot table entries of a slot are written only by the thread
//     that reads them in the lookups, so the next lane's lookup sees them
//     in program order, without a barrier; everything else a lane writes
//     (mirror words, ecnt) is read by the next lane only after the next
//     barrier;
//   * three lookup results are in flight (a ring): lane j publishes into
//     slot j % 3 and block 0 zeroes slot (j + 1) % 3 before it reaches lane
//     j's barrier, after every block has read it (at lane j - 2);
//   * reads of what another block wrote go to L2 (ld.global.cg), and the
//     barrier is a release add and acquire loads at gpu scope.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int LOOKUPS = 3;  // find(key1), find(key2), the free slot
constexpr int RING = 3;     // lanes whose lookup results are in flight
constexpr int SCRATCH_INTS = 1 + RING * LOOKUPS;  // arrivals, then the ring
constexpr int32_t EMPTY_KEY = -1;
// opcodes and result codes (repro_torch/core/graph.py)
constexpr int OP_NOP = 0;
constexpr int OP_ADD_V = 1;
constexpr int OP_REM_V = 2;
constexpr int OP_CON_V = 3;
constexpr int OP_ADD_E = 4;
constexpr int OP_CON_E = 6;
constexpr int32_t R_FALSE = 0;
constexpr int32_t R_TRUE = 1;
constexpr int32_t R_VERTEX_NOT_PRESENT = 2;
constexpr int32_t R_EDGE_NOT_PRESENT = 3;
constexpr int32_t R_EDGE_PRESENT = 4;
constexpr int32_t R_EDGE_ADDED = 5;
constexpr int32_t R_EDGE_REMOVED = 6;
constexpr int32_t R_TABLE_FULL = 7;
constexpr int32_t R_CAS_FAIL = 8;

struct State {
  int32_t* vkey;
  uint8_t* valive;
  int32_t* vver;
  int32_t* ecnt;
  uint32_t* adj;
  uint32_t* adj_in;
  int v_n;
  int w_n;
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t* word_of(uint32_t* m, const State& s,
                                             int row, int col) {
  return m + static_cast<size_t>(row) * s.w_n + (col >> 5);
}

__device__ __forceinline__ bool bit(const State& s, int row, int col) {
  return (__ldcg(word_of(s.adj, s, row, col)) >> (col & 31)) & 1u;
}

// Whether this thread writes slot ``slot``'s table entries: the thread of
// the owning block that reads them in ``lookups``, so that its next lookup
// sees them in program order.
__device__ __forceinline__ bool owns(int slot, int lo, int hi) {
  return slot >= lo && slot < hi &&
         (slot - lo) % THREADS == static_cast<int>(threadIdx.x);
}

__device__ __forceinline__ void bump(int32_t* p) {
  atomicAdd(p, 1);  // two's complement: wraps as int32
}

// Every block arrives once a lane, so lane j's barrier is passed when
// `arrivals` reaches gridDim.x * (j + 1). Thread 0 then reads the lane's
// lookups into ``found`` (-1: none).
__device__ __forceinline__ void barrier_and_read(unsigned* arrivals,
                                                 unsigned target,
                                                 const unsigned* got, int v_n,
                                                 int* found) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1u);
    while (load_acquire(arrivals) < target) {
    }
    __threadfence();
#pragma unroll
    for (int q = 0; q < LOOKUPS; ++q) {
      const unsigned enc = __ldcg(got + q);
      found[q] = enc ? v_n - static_cast<int>(enc) : -1;
    }
  }
  __syncthreads();
}

// This block's lowest hits of the three lookups over its slice [lo, hi),
// published into ``got`` as atomicMax of v_n - slot.
__device__ __forceinline__ void lookups(const State& s, int lo, int hi,
                                        int32_t k1, int32_t k2,
                                        unsigned* got,
                                        unsigned (*red)[WARPS]) {
  unsigned best[LOOKUPS] = {0u, 0u, 0u};
  for (int slot = lo + static_cast<int>(threadIdx.x); slot < hi;
       slot += THREADS) {
    const int32_t key = s.vkey[slot];
    const bool alive = s.valive[slot] != 0;
    const unsigned enc = static_cast<unsigned>(s.v_n - slot);
    if (alive && key == k1) best[0] = max(best[0], enc);
    if (alive && key == k2) best[1] = max(best[1], enc);
    if (key == EMPTY_KEY) best[2] = max(best[2], enc);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < LOOKUPS; ++q) {
    best[q] = __reduce_max_sync(FULL, best[q]);
    if (lane == 0) red[q][warp] = best[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < LOOKUPS; ++q) {
      const unsigned m = __reduce_max_sync(FULL, red[q][lane]);
      if (lane == 0 && m) atomicMax(got + q, m);
    }
  }
}

// AddVertex's scrub of slot t, split over the grid: row t of both mirrors
// zeroed, bit t cleared in every other row (row t's word is in the zeroed
// row, so no two threads write one word).
__device__ __forceinline__ void scrub(const State& s, int t, int g,
                                      int stride) {
  for (int w = g; w < s.w_n; w += stride) {
    s.adj[static_cast<size_t>(t) * s.w_n + w] = 0u;
    s.adj_in[static_cast<size_t>(t) * s.w_n + w] = 0u;
  }
  const uint32_t m = 1u << (t & 31);
  for (int r = g; r < s.v_n; r += stride) {
    if (r == t) continue;
    uint32_t* a = word_of(s.adj, s, r, t);
    uint32_t* b = word_of(s.adj_in, s, r, t);
    const uint32_t wa = __ldcg(a), wb = __ldcg(b);
    if (wa & m) *a = wa & ~m;
    if (wb & m) *b = wb & ~m;
  }
}

// RemoveVertex's in-source bumps of slot t, split over the grid: ecnt of
// every live in-source of t (t itself counts as live: it is marked dead
// by its owner meanwhile, and was alive before the lane).
__device__ __forceinline__ void sweep(const State& s, int t, int g,
                                      int stride) {
  const uint32_t* row = s.adj_in + static_cast<size_t>(t) * s.w_n;
  for (int w = g; w < s.w_n; w += stride) {
    uint32_t word = __ldcg(row + w);
    while (word) {
      const int c = (w << 5) + __ffs(word) - 1;
      word &= word - 1;
      if (c < s.v_n && (c == t || __ldcg(s.valive + c) != 0))
        bump(s.ecnt + c);
    }
  }
}

// AddEdge / RemoveEdge / ContainsEdge, in one thread: the slots are known.
__device__ __forceinline__ int32_t edge_op(const State& s, int op, int rk,
                                           int rl, int32_t expect) {
  if (rk < 0 || rl < 0) return R_VERTEX_NOT_PRESENT;
  const bool present = bit(s, rk, rl);
  if (op == OP_CON_E) return present ? R_EDGE_PRESENT : R_EDGE_NOT_PRESENT;
  if (expect >= 0 && __ldcg(s.ecnt + rk) != expect) return R_CAS_FAIL;
  const bool add = op == OP_ADD_E;
  if (add && present) return R_EDGE_PRESENT;
  if (!add && !present) return R_EDGE_NOT_PRESENT;
  uint32_t* a = word_of(s.adj, s, rk, rl);
  uint32_t* b = word_of(s.adj_in, s, rl, rk);
  const uint32_t ma = 1u << (rl & 31), mb = 1u << (rk & 31);
  const uint32_t wa = __ldcg(a), wb = __ldcg(b);
  *a = add ? (wa | ma) : (wa & ~ma);
  *b = add ? (wb | mb) : (wb & ~mb);
  bump(s.ecnt + rk);
  return add ? R_EDGE_ADDED : R_EDGE_REMOVED;
}

__global__ void __launch_bounds__(THREADS)
serial_lanes(State s, const int32_t* __restrict__ opcode,
             const int32_t* __restrict__ key1,
             const int32_t* __restrict__ key2,
             const int32_t* __restrict__ expect,
             const uint8_t* __restrict__ mask, int32_t* res,
             unsigned* scratch, int b_n) {
  __shared__ unsigned red[LOOKUPS][WARPS];
  __shared__ int found[LOOKUPS];
  const int nb = gridDim.x;
  const int per = (s.v_n + nb - 1) / nb;
  const int lo = min(static_cast<int>(blockIdx.x) * per, s.v_n);
  const int hi = min(lo + per, s.v_n);
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int stride = nb * THREADS;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  unsigned* arrivals = scratch;
  unsigned* ring = scratch + 1;
  unsigned j = 0;  // serial lanes so far
  for (int i0 = 0; i0 < b_n; i0 += 32) {
    const int mine = i0 + (threadIdx.x & 31);
    const unsigned sel = __ballot_sync(FULL, mine < b_n && mask[mine] != 0);
    for (unsigned left = sel; left; left &= left - 1) {
      const int i = i0 + __ffs(left) - 1;
      const int op = min(max(opcode[i], OP_NOP), OP_CON_E);
      const int32_t k1 = key1[i], k2 = key2[i];
      unsigned* got = ring + (j % RING) * LOOKUPS;
      if (leader) {
        unsigned* next = ring + ((j + 1) % RING) * LOOKUPS;
        for (int q = 0; q < LOOKUPS; ++q) next[q] = 0u;
      }
      lookups(s, lo, hi, k1, k2, got, red);
      ++j;
      barrier_and_read(arrivals, j * nb, got, s.v_n, found);
      const int f1 = found[0], f2 = found[1], free_slot = found[2];
      if (op == OP_ADD_V) {
        if (f1 < 0 && free_slot >= 0) {
          if (owns(free_slot, lo, hi)) {
            s.vkey[free_slot] = k1;
            s.valive[free_slot] = 1;
            s.vver[free_slot] = static_cast<int32_t>(
                static_cast<uint32_t>(s.vver[free_slot]) + 1u);
            s.ecnt[free_slot] = 0;
          }
          scrub(s, free_slot, g, stride);
        }
        if (leader)
          res[i] = f1 >= 0 ? R_FALSE
                           : (free_slot < 0 ? R_TABLE_FULL : R_TRUE);
      } else if (op == OP_REM_V) {
        if (f1 >= 0) {
          if (owns(f1, lo, hi)) {
            s.valive[f1] = 0;
            s.vver[f1] = static_cast<int32_t>(
                static_cast<uint32_t>(s.vver[f1]) + 1u);
            bump(s.ecnt + f1);
          }
          sweep(s, f1, g, stride);
        }
        if (leader) res[i] = f1 >= 0 ? R_TRUE : R_FALSE;
      } else if (leader) {
        if (op == OP_CON_V)
          res[i] = f1 >= 0 ? R_TRUE : R_FALSE;
        else if (op == OP_NOP)
          res[i] = R_FALSE;
        else
          res[i] = edge_op(s, op, f1, f2, expect[i]);
      }
    }
  }
}

}  // namespace

// The int32 words of scratch the launch takes, zeroed by the caller.
extern "C" int serial_pass_scratch_ints() { return SCRATCH_INTS; }

// The pass over the mask-selected lanes of b_n, on a state of v_n slots
// and w_n words a row: one cooperative launch of one block an SM.
extern "C" int serial_pass_launch(void* vkey, void* valive, void* vver,
                                  void* ecnt, void* adj, void* adj_in,
                                  const void* opcode, const void* key1,
                                  const void* key2, const void* expect,
                                  const void* mask, void* res, void* scratch,
                                  int b_n, int v_n, int w_n, void* stream) {
  if (b_n <= 0 || v_n <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, serial_lanes,
                                                        THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  State s{static_cast<int32_t*>(vkey), static_cast<uint8_t*>(valive),
          static_cast<int32_t*>(vver), static_cast<int32_t*>(ecnt),
          static_cast<uint32_t*>(adj), static_cast<uint32_t*>(adj_in), v_n,
          w_n};
  const auto* op = static_cast<const int32_t*>(opcode);
  const auto* k1 = static_cast<const int32_t*>(key1);
  const auto* k2 = static_cast<const int32_t*>(key2);
  const auto* ex = static_cast<const int32_t*>(expect);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* r = static_cast<int32_t*>(res);
  auto* sc = static_cast<unsigned*>(scratch);
  void* args[] = {&s, &op, &k1, &k2, &ex, &m, &r, &sc, &b_n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(serial_lanes),
                                    dim3(sms), dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
