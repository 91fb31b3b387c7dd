// B9 and B5: batched lane-ordered edge writes, dense and packed, on sm_90a.
// B9 replaces repro/kernels/edge_update/kernel.py::edge_update_pallas,
// B5 replaces repro/kernels/edge_update/kernel.py::edge_update_packed_pallas.
//
// Contract (in place; the wrappers in ops.py copy first, as JAX returns new
// arrays), lanes i of rows, cols, vals, mask int32[B]:
//   a lane fires when mask[i] > 0; a masked-off lane's row, column and
//   value are never used (they may be out of range);
//   B9: adj uint8[R, C]    adj[row, col] = (uint8) vals[i]
//   B5: adj int32[R, W]    bit col of row: set when vals[i] > 0, else clear
//   lanes apply in order: on a duplicate (row, col) the last firing lane wins;
//   ecnt int32[R]: += 1 for every firing lane, duplicates included.
// A firing lane whose row is out of range writes nothing; one whose column
// is out of range still bumps ecnt (the JAX oracle drops the write alone).
//
// What bounds it: the bytes of the lanes, the touched cells or words and
// the ecnt rows (a few KB for B = 1,024), so one launch is bound by its
// latency: a few dependent trips to device memory, and at a few thousand
// lanes the scattered stores and atomics one SM can issue. The Pallas
// kernel scans the whole batch in lane order once per 8-row stripe; blocks
// do not run in order here, so the lane order is rebuilt from the lane
// indices instead. The last firing lane of a target is the largest lane
// index that claims it, found in one pass over the lanes with an
// open-addressing hash table of 2 * next_pow2(B) slots (load factor at
// most 1/2): the 64-bit key row * C + col (B5: the bit index
// row * 32W + col) claims a slot by atomicCAS, then raises the slot's lane
// by atomicMax. A lane wins when its slot holds its own index, so the
// winners have distinct targets and their writes do not race: B9's store
// their bytes (byte stores do not tear their neighbours); B5's winners of
// one word may own different bits of it, so each sets or clears its bit
// with atomicOr / atomicAnd on the uint32 word (bit 31 is the int32 sign
// bit and is handled as any other).
//
// Runs of equal keys in neighbouring threads of a warp (a batch that puts
// every lane on one row or one target, or a sorted one) are merged first,
// with two shuffles and a ballot: only the run's last thread claims the
// target (it holds the run's largest lane), and only it adds the run's
// length to ecnt. So 1,024 lanes on one row cost 32 atomics, one a warp.
// ecnt takes those atomics straight from the lanes, as early as the lanes
// are loaded, and B5's winners set or clear their bits with atomicOr /
// atomicAnd: counting each distinct row and merging each word's winners in
// shared memory first, so that one thread writes (w & ~clear) | set, adds
// a pass over a table after the block's barrier and measured slower.
// __match_any_sync would merge equal keys anywhere in a warp, but its cost
// grows with the distinct keys a warp holds (32 in a random batch).
//
// Up to ONE_BLOCK_LANES lanes this is one launch of one block, the table
// in shared memory and each thread holding its <= 2 lanes in registers.
// Above it the same table lives in a scratch of
// edge_update_scratch_bytes(b_n) bytes that the caller allocates
// (*_scratch_launch): three launches on the stream, clear, claim, and
// decide-and-write, spread over as many blocks as the lanes fill. The cap
// is where one block stops being the faster: its time grows with the
// lanes one SM must store, the scratch path's hardly does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ONE_BLOCK_LANES = 2048;
constexpr int ONE_BLOCK_THREADS = 1024;
constexpr int LANES_PER_THREAD = ONE_BLOCK_LANES / ONE_BLOCK_THREADS;
constexpr int WIDE_THREADS = 256;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int NO_ROW = -1;
constexpr int SLOT_BYTES = 12;  // a slot: target key 8, its lane 4 bytes

__device__ __forceinline__ unsigned lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned hash64(unsigned long long k, int log_t) {
  return static_cast<unsigned>((k * 0x9E3779B97F4A7C15ull) >> (64 - log_t));
}

struct Lane {
  int r, c, v;
  bool row_ok;  // fires with its row in range: bumps ecnt
  bool ok;      // and its column too: writes
};

__device__ __forceinline__ Lane load_lane(int i, int b_n,
                                          const int32_t* __restrict__ rows,
                                          const int32_t* __restrict__ cols,
                                          const int32_t* __restrict__ vals,
                                          const int32_t* __restrict__ mask,
                                          int r_n, int c_n) {
  // the four loads go out together; the mask decides what is used
  Lane l{0, 0, 0, false, false};
  if (i < b_n) {
    const int r = rows[i], c = cols[i], v = vals[i];
    if (mask[i] > 0) {
      l = Lane{r, c, v, r >= 0 && r < r_n, false};
      l.ok = l.row_ok && c >= 0 && c < c_n;
    }
  }
  return l;
}

__device__ __forceinline__ unsigned long long target(const Lane& l, int c_n) {
  return l.ok ? static_cast<unsigned long long>(l.r) * c_n + l.c : NO_KEY;
}

__device__ __forceinline__ int row_key(const Lane& l) {
  return l.row_ok ? l.r : NO_ROW;
}

// Whether the next thread of the warp holds the same key (then it holds
// the later lane). Every thread of the warp calls it.
template <class K>
__device__ __forceinline__ bool later_same(K key) {
  const K next = __shfl_down_sync(FULL, key, 1);
  return lane_id() < 31 && next == key;
}

// The length of the run of equal keys in neighbouring threads that ends
// at this thread, 0 where it does not end here. Every thread of the warp
// calls it.
template <class K>
__device__ __forceinline__ int run_end(K key) {
  const unsigned lane = lane_id();
  const K prev = __shfl_up_sync(FULL, key, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != key);
  if (later_same(key)) return 0;
  const unsigned upto = heads & (FULL >> (31 - lane));
  return static_cast<int>(lane) - (31 - __clz(upto)) + 1;
}

// Lane i claims its target ``key`` (NO_KEY: none) in the table of
// 1 << log_t slots; returns the slot, or -1 where the lane does not claim
// (no target, or a later lane of the warp's run claims it). Every thread
// of the warp calls it.
__device__ __forceinline__ int claim(unsigned long long* tkey, int* tlane,
                                     int log_t, unsigned long long key,
                                     int i) {
  if (later_same(key) || key == NO_KEY) return -1;
  const unsigned mask = (1u << log_t) - 1;
  unsigned s = hash64(key, log_t);
  for (;;) {
    const unsigned long long prev = atomicCAS(tkey + s, NO_KEY, key);
    if (prev == NO_KEY || prev == key) break;
    s = (s + 1) & mask;
  }
  atomicMax(tlane + s, i);
  return static_cast<int>(s);
}

// ecnt[r] += the lanes of this thread's run of row ``r`` (NO_ROW: none).
// Every thread of the warp calls it.
__device__ __forceinline__ void bump_row(int32_t* ecnt, int r) {
  const int n = run_end(r);
  if (n > 0 && r != NO_ROW) atomicAdd(ecnt + r, n);
}

template <bool PACKED>
__device__ __forceinline__ void write_winner(void* adj, int stride,
                                             const Lane& l) {
  if (PACKED) {
    uint32_t* word = static_cast<uint32_t*>(adj) +
                     static_cast<size_t>(l.r) * stride + (l.c >> 5);
    const uint32_t bit = 1u << (l.c & 31);
    if (l.v > 0)
      atomicOr(word, bit);
    else
      atomicAnd(word, ~bit);
  } else {
    static_cast<uint8_t*>(adj)[static_cast<size_t>(l.r) * stride + l.c] =
        static_cast<uint8_t>(l.v);
  }
}

// B <= ONE_BLOCK_LANES: one block, lane i = k * blockDim.x + threadIdx.x.
template <bool PACKED>
__global__ void __launch_bounds__(ONE_BLOCK_THREADS)
one_block(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
          const int32_t* __restrict__ vals, const int32_t* __restrict__ mask,
          int b_n, int r_n, int c_n, int stride, int log_t, void* adj,
          int32_t* ecnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = 1 << log_t;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  auto* tkey = reinterpret_cast<unsigned long long*>(smem);
  int* tlane = reinterpret_cast<int*>(tkey + t);
  for (int s = tid; s < t; s += nt) {
    tkey[s] = NO_KEY;
    tlane[s] = -1;
  }
  Lane lane[LANES_PER_THREAD];
#pragma unroll
  for (int k = 0; k < LANES_PER_THREAD; ++k)
    lane[k] = load_lane(k * nt + tid, b_n, rows, cols, vals, mask, r_n, c_n);
  const int per = (b_n + nt - 1) / nt;  // the same in every thread
#pragma unroll
  for (int k = 0; k < LANES_PER_THREAD; ++k)
    if (k < per) bump_row(ecnt, row_key(lane[k]));
  __syncthreads();
  int slot[LANES_PER_THREAD];
#pragma unroll
  for (int k = 0; k < LANES_PER_THREAD; ++k)
    slot[k] = k < per ? claim(tkey, tlane, log_t, target(lane[k], c_n),
                              k * nt + tid)
                      : -1;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LANES_PER_THREAD; ++k)
    if (slot[k] >= 0 && tlane[slot[k]] == k * nt + tid)
      write_winner<PACKED>(adj, stride, lane[k]);
}

// B > ONE_BLOCK_LANES: the scratch holds tkey[T], tlane[T], then lslot[B]
// (the slot a lane claimed, -1 where none).
__global__ void wide_clear(void* scratch, int log_t) {
  const int t = 1 << log_t;
  auto* tkey = static_cast<unsigned long long*>(scratch);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < t) {
    tkey[s] = NO_KEY;
    reinterpret_cast<int*>(tkey + t)[s] = -1;
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
wide_claim(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
           const int32_t* __restrict__ vals, const int32_t* __restrict__ mask,
           int b_n, int r_n, int c_n, int log_t, void* scratch,
           int32_t* ecnt) {
  const int t = 1 << log_t;
  auto* tkey = static_cast<unsigned long long*>(scratch);
  int* tlane = reinterpret_cast<int*>(tkey + t);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Lane l = load_lane(i, b_n, rows, cols, vals, mask, r_n, c_n);
  bump_row(ecnt, row_key(l));
  const int s = claim(tkey, tlane, log_t, target(l, c_n), i);
  if (i < b_n) tlane[t + i] = s;
}

template <bool PACKED>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_apply(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
           const int32_t* __restrict__ vals, const int32_t* __restrict__ mask,
           int b_n, int r_n, int c_n, int stride, int log_t,
           const void* scratch, void* adj) {
  const int t = 1 << log_t;
  const int* tlane = reinterpret_cast<const int*>(
      static_cast<const unsigned long long*>(scratch) + t);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b_n) return;
  const int s = tlane[t + i];
  if (s >= 0 && tlane[s] == i)
    write_winner<PACKED>(adj, stride,
                         load_lane(i, b_n, rows, cols, vals, mask, r_n, c_n));
}

// log2 of the table size 2 * next_pow2(b_n)
int log2_slots(int b_n) {
  int lg = 1;
  while ((1 << (lg - 1)) < b_n) ++lg;
  return lg;
}

template <bool PACKED>
int run(void* adj, void* ecnt, const void* rows, const void* cols,
        const void* vals, const void* mask, int b_n, int r_n, int c_n,
        int stride, void* stream) {
  if (b_n <= 0) return 0;
  if (b_n > ONE_BLOCK_LANES) return static_cast<int>(cudaErrorInvalidValue);
  const int log_t = log2_slots(b_n);
  const int smem = SLOT_BYTES << log_t;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        one_block<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = b_n < ONE_BLOCK_THREADS ? (b_n + 31) / 32 * 32
                                              : ONE_BLOCK_THREADS;
  one_block<PACKED><<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(mask),
      b_n, r_n, c_n, stride, log_t, adj, static_cast<int32_t*>(ecnt));
  return static_cast<int>(cudaGetLastError());
}

// Any b_n: one block up to ONE_BLOCK_LANES (``scratch`` unused), else the
// three launches on ``scratch``.
template <bool PACKED>
int run_any(void* adj, void* ecnt, const void* rows, const void* cols,
            const void* vals, const void* mask, void* scratch, int b_n,
            int r_n, int c_n, int stride, void* stream) {
  if (b_n <= ONE_BLOCK_LANES)
    return run<PACKED>(adj, ecnt, rows, cols, vals, mask, b_n, r_n, c_n,
                       stride, stream);
  const int log_t = log2_slots(b_n);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const int32_t*>(vals);
  const auto* m = static_cast<const int32_t*>(mask);
  const int lane_blocks = (b_n + WIDE_THREADS - 1) / WIDE_THREADS;
  wide_clear<<<((1 << log_t) + WIDE_THREADS - 1) / WIDE_THREADS,
               WIDE_THREADS, 0, st>>>(scratch, log_t);
  wide_claim<<<lane_blocks, WIDE_THREADS, 0, st>>>(
      r, c, v, m, b_n, r_n, c_n, log_t, scratch,
      static_cast<int32_t*>(ecnt));
  wide_apply<PACKED><<<lane_blocks, WIDE_THREADS, 0, st>>>(
      r, c, v, m, b_n, r_n, c_n, stride, log_t, scratch, adj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B9: adj uint8[r_n, c_n]; b_n <= ONE_BLOCK_LANES
extern "C" int edge_update_launch(void* adj, void* ecnt, const void* rows,
                                  const void* cols, const void* vals,
                                  const void* mask, int b_n, int r_n, int c_n,
                                  void* stream) {
  return run<false>(adj, ecnt, rows, cols, vals, mask, b_n, r_n, c_n, c_n,
                    stream);
}

// B5: adj int32[r_n, w_n] words; b_n <= ONE_BLOCK_LANES
extern "C" int edge_update_packed_launch(void* adj, void* ecnt,
                                         const void* rows, const void* cols,
                                         const void* vals, const void* mask,
                                         int b_n, int r_n, int w_n,
                                         void* stream) {
  return run<true>(adj, ecnt, rows, cols, vals, mask, b_n, r_n, 32 * w_n,
                   w_n, stream);
}

// The bytes of scratch *_scratch_launch needs for b_n lanes: 0 up to
// ONE_BLOCK_LANES, else 12 * slots + 4 * b_n, slots = 2 * next_pow2(b_n).
extern "C" long long edge_update_scratch_bytes(int b_n) {
  if (b_n <= ONE_BLOCK_LANES) return 0;
  return (static_cast<long long>(SLOT_BYTES) << log2_slots(b_n)) +
         4ll * b_n;
}

extern "C" int edge_update_one_block_lanes() { return ONE_BLOCK_LANES; }

// B9 for any b_n, with edge_update_scratch_bytes(b_n) bytes of scratch
extern "C" int edge_update_scratch_launch(void* adj, void* ecnt,
                                          const void* rows, const void* cols,
                                          const void* vals, const void* mask,
                                          void* scratch, int b_n, int r_n,
                                          int c_n, void* stream) {
  return run_any<false>(adj, ecnt, rows, cols, vals, mask, scratch, b_n, r_n,
                        c_n, c_n, stream);
}

// B5 for any b_n, with the same scratch
extern "C" int edge_update_packed_scratch_launch(
    void* adj, void* ecnt, const void* rows, const void* cols,
    const void* vals, const void* mask, void* scratch, int b_n, int r_n,
    int w_n, void* stream) {
  return run_any<true>(adj, ecnt, rows, cols, vals, mask, scratch, b_n, r_n,
                       32 * w_n, w_n, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
