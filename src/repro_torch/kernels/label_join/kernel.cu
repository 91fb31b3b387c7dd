// B4 and B8: batched 2-hop label joins, on sm_90a.
// B4 replaces repro/kernels/label_join/kernel.py::label_join_packed_pallas,
// B8 replaces repro/kernels/label_join/kernel.py::label_join_pallas.
//
// Contract:
//   B4 packed: out, in int32[Q, W] label bitsets   (bit l of word l/32;
//              words are int32 bit patterns read as uint32)
//   B8 dense:  out, in int32[Q, L] label slabs     (landmark l counts where
//              out[q, l] > 0 and in[q, l] > 0, the test of JAX's kernel:
//              zero and negative entries are not labels)
//   -> hits int32[Q]  number of landmarks set in both rows of query q
//      hub  int32[Q]  smallest such landmark, -1 when there is none
//
// B4, what bounds it: the bytes of the two label rows per query (2 * W * 4)
// plus 8 bytes of output; at the index's Q = 64 and W = 32 that is 16 KB,
// so one launch is bound by its launch latency, not by the card. The
// design is the simplest that reads each word once, coalesced:
//   * one warp per query; lane j reads words j, j + 32, ... of both rows,
//     so a warp's loads are contiguous;
//   * a lane whose OUT word is zero skips the IN read: canonical-hub
//     pruning leaves most OUT words empty (the counterpart of the Pallas
//     kernel's all-zero OUT tile skip);
//   * a lane walks its words in ascending order, so its first common bit
//     (32 * w + ffs - 1) is its smallest; a warp sum of the popcounts and a
//     warp min of the lanes' first hits give hits and hub. Sum and min do
//     not depend on order, so the result is exact on every run.
// No Q padding is needed (the Pallas wrapper pads Q to 8 for TPU tiles).
//
// B4 by slot (label_join_slots_launch), the form query_reach launches:
//   out_label, in_label int32[V, W]  alive bool[V]  src, dst int32[Q]
//   -> hits, hub as above on rows out_label[src] and in_label[dst], and
//      src_ok, dst_ok bool[Q]  slot >= 0 and alive (slots clamped into
//      [0, V - 1] first); a pair with an endpoint not ok joins zero rows
// A query's warp reads its two slots and flags itself, so the gather, the
// endpoint tests and the join are one launch (gathering the [Q, W] slabs
// in PyTorch takes about 20 small kernels). It reads both rows in
// full (at the index's W = 32 one word a lane of each), whatever the
// endpoints' liveness, so that the label and alive loads go out together:
// two dependent round trips (slots, then rows and alive), not three.
//
// B8, what bounds it on the H100: bytes. It must read the OUT slab (4 L
// bytes a query) and the IN entries under an OUT entry > 0; the arithmetic
// is a compare and an add an entry. At the phase-7 probe (Q = 64, L =
// 1,024: a 262 KB slab) that is ~0.08 us of HBM time, so one launch is
// bound by latency: the launch itself and the round trips to HBM (the
// caller finds L2 cold). At Q = 16,384 (a 67 MB slab) it is bound by the
// HBM rate. The design does, for each:
//   * a row's loads in flight together: a query's landmark axis is spread
//     over a group of 32 * WPQ threads, and each thread's B8_TILE / (32 *
//     WPQ * 4) 16-byte OUT loads (int4, read-only path) are unrolled and
//     written before any is consumed;
//   * the pruned-label skip at the card's grain: a thread reads its IN
//     chunk only where its OUT chunk holds an entry > 0 (the sector-level
//     counterpart of the Pallas kernel's all-zero OUT tile skip), issuing
//     all its IN loads together: one dependent round trip follows the OUT
//     loads, none for an empty chunk;
//   * work a launch sized from Q: WPQ (warps a query: 8, 4, 2 or 1) is the
//     largest at which all Q * WPQ warps fit on the card at once, so the
//     probe's Q = 64 (and any Q up to 1,056 on the H100) runs a block of 8
//     warps a query (one 16-byte load a thread at L = 1,024: two round
//     trips in all), and a large Q one warp a query, 8 loads a lane, on a
//     grid of as many blocks as the card holds at once, each walking
//     queries in a stride. ptxas keeps these instances at 32 registers for
//     full occupancy and interleaves a thread's loads with the waits on
//     them, about two in flight, whatever the source order (predicated
//     inline-PTX loads did not change it): so few loads
//     a thread is what keeps a small Q to two round trips, and at a large
//     Q the 64 resident warps a SM keep the HBM busy;
//   * alignment: the 16-byte loads need 16-byte aligned rows, which L % 4
//     != 0 or a view at an element offset breaks. Where OUT and IN share
//     their address modulo 16, a row's first (up to 3) and last (up to 3)
//     entries are read by scalar loads beside the first tile's vectors; where
//     they do not, the kernel instance with 4-byte loads runs instead;
//   * an exact reduction: each thread keeps its hits and its smallest hit,
//     a warp sums and mins them by shuffles, and the warps of a query
//     through shared memory. Sum and min do not depend on order, so every
//     run gives the same answer, with no atomics and no second pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int32_t NO_HUB = 0x7fffffff;

__device__ __forceinline__ void warp_finish(int hits, int32_t hub, int q,
                                            int lane,
                                            int32_t* __restrict__ hits_out,
                                            int32_t* __restrict__ hub_out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hits += __shfl_xor_sync(FULL, hits, o);
    hub = min(hub, __shfl_xor_sync(FULL, hub, o));
  }
  if (lane == 0) {
    hits_out[q] = hits;
    hub_out[q] = hits ? hub : -1;
  }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
label_join_packed_kernel(const uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ in, int q_n, int w_n,
                         int32_t* __restrict__ hits_out,
                         int32_t* __restrict__ hub_out) {
  const int q = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= q_n) return;  // whole warp
  const uint32_t* a = out + static_cast<size_t>(q) * w_n;
  const uint32_t* b = in + static_cast<size_t>(q) * w_n;
  int hits = 0;
  int32_t hub = NO_HUB;
  for (int w = lane; w < w_n; w += 32) {
    const uint32_t x = a[w];
    if (x == 0u) continue;  // pruned OUT word: no IN read
    const uint32_t c = x & b[w];
    hits += __popc(c);
    if (c != 0u && hub == NO_HUB) hub = (w << 5) + __ffs(c) - 1;
  }
  warp_finish(hits, hub, q, lane, hits_out, hub_out);
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
label_join_slots_kernel(const uint32_t* __restrict__ out_label,
                        const uint32_t* __restrict__ in_label,
                        const uint8_t* __restrict__ alive,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ dst, int q_n, int w_n,
                        int v_n, int32_t* __restrict__ hits_out,
                        int32_t* __restrict__ hub_out,
                        uint8_t* __restrict__ src_ok,
                        uint8_t* __restrict__ dst_ok) {
  const int q = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= q_n) return;  // whole warp
  const int s = src[q], d = dst[q];
  const int sc = min(max(s, 0), v_n - 1), dc = min(max(d, 0), v_n - 1);
  // the rows are read before the endpoints are known to be ok (the clamped
  // rows exist), so the alive and label loads share one round trip
  const uint8_t s_alive = alive[sc], d_alive = alive[dc];
  const uint32_t* a = out_label + static_cast<size_t>(sc) * w_n;
  const uint32_t* b = in_label + static_cast<size_t>(dc) * w_n;
  int hits = 0;
  int32_t hub = NO_HUB;
  for (int w = lane; w < w_n; w += 32) {
    const uint32_t c = a[w] & b[w];
    hits += __popc(c);
    if (c != 0u && hub == NO_HUB) hub = (w << 5) + __ffs(c) - 1;
  }
  const bool sok = s >= 0 && s_alive, dok = d >= 0 && d_alive;
  if (lane == 0) {
    src_ok[q] = sok;
    dst_ok[q] = dok;
  }
  if (!(sok && dok)) {  // warp-uniform: an endpoint not ok joins zero rows
    hits = 0;
    hub = NO_HUB;
  }
  warp_finish(hits, hub, q, lane, hits_out, hub_out);
}

constexpr int B8_THREADS = 256;   // a block: 8 warps
constexpr int B8_TILE = 1024;     // entries of a row a query's group loads
                                  // in one round

template <int VW>
struct Chunk {  // VW neighbouring entries of a row, in registers
  int32_t v[VW];
};

template <int VW>
__device__ __forceinline__ Chunk<VW> load_chunk(const int32_t* p) {
  Chunk<VW> c;
  if constexpr (VW == 4) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(p));
    c.v[0] = r.x;
    c.v[1] = r.y;
    c.v[2] = r.z;
    c.v[3] = r.w;
  } else {
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int VW>
__device__ __forceinline__ bool any_label(const Chunk<VW>& c) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < VW; ++j) any |= c.v[j] > 0;
  return any;
}

// WPQ warps a query; VW entries a load (4: int4 on rows that share their
// alignment, 1: int)
template <int WPQ, int VW>
__global__ void __launch_bounds__(B8_THREADS)
label_join_kernel(const int32_t* __restrict__ out,
                  const int32_t* __restrict__ in, int q_n, int l_n,
                  int32_t* __restrict__ hits_out,
                  int32_t* __restrict__ hub_out) {
  constexpr int T = 32 * WPQ;                 // threads of a query
  constexpr int QPB = B8_THREADS / T;         // queries a block
  constexpr int U = B8_TILE / (T * VW);       // loads a thread a round
  __shared__ int32_t part_hits[B8_THREADS / 32], part_hub[B8_THREADS / 32];
  const int group = threadIdx.x / T, t = threadIdx.x % T;
  const int warp = threadIdx.x >> 5;
  // the loop's trip count is the same for the whole block (barriers)
  for (long long qb = blockIdx.x; qb * QPB < q_n; qb += gridDim.x) {
    const long long qq = qb * QPB + group;
    const bool live = qq < q_n;
    int hits = 0;
    int32_t hub = NO_HUB;
    if (live) {
      const int32_t* a = out + static_cast<size_t>(qq) * l_n;
      const int32_t* b = in + static_cast<size_t>(qq) * l_n;
      // entries before the row's first 16-byte boundary, then nv chunks,
      // then the tail from tail0 (IN shares OUT's alignment)
      int head = 0;
      if constexpr (VW == 4)
        head = min(l_n, static_cast<int>(
                            (16u - (reinterpret_cast<uintptr_t>(a) & 15u)) &
                            15u) >> 2);
      const int nv = (l_n - head) / VW;
      const int tail0 = head + nv * VW;
      int epos = 0;   // this thread's head or tail entry, if any
      int32_t ea = 0;
      if constexpr (VW == 4) {
        const int e = t < head ? t : tail0 + t - head;
        if (t < head || e < l_n) {
          epos = e;
          ea = __ldg(a + e);
        }
      }
      // one round at least, so that the head and tail are read
      for (int v0 = 0; v0 == 0 || v0 < nv; v0 += T * U) {
        Chunk<VW> x[U], y[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int v = v0 + t + k * T;
          x[k] = v < nv ? load_chunk<VW>(a + head + v * VW) : Chunk<VW>{};
        }
        const int32_t eb = (v0 == 0 && ea > 0) ? __ldg(b + epos) : 0;
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int v = v0 + t + k * T;
          y[k] = any_label<VW>(x[k]) ? load_chunk<VW>(b + head + v * VW)
                                     : Chunk<VW>{};
        }
        if (eb > 0) {   // ea > 0 too
          ++hits;
          hub = min(hub, epos);
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            if (x[k].v[j] > 0 && y[k].v[j] > 0) {
              ++hits;
              hub = min(hub, head + (v0 + t + k * T) * VW + j);
            }
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      hits += __shfl_xor_sync(FULL, hits, o);
      hub = min(hub, __shfl_xor_sync(FULL, hub, o));
    }
    if constexpr (WPQ > 1) {   // the group's warps through shared memory
      if ((threadIdx.x & 31) == 0) {
        part_hits[warp] = hits;
        part_hub[warp] = hub;
      }
      __syncthreads();
      if (t == 0) {
        hits = 0;
        hub = NO_HUB;
#pragma unroll
        for (int w = 0; w < WPQ; ++w) {
          hits += part_hits[warp + w];
          hub = min(hub, part_hub[warp + w]);
        }
      }
      __syncthreads();   // part_* is rewritten in the next stride
    }
    if (t == 0 && live) {
      hits_out[qq] = hits;
      hub_out[qq] = hits ? hub : -1;
    }
  }
}

// the current device's SM count and the warps one SM holds at once
struct Card {
  int sms = 0, warps_per_sm = 0;
};

Card card() {
  static Card cached[64];   // by device ordinal; sms == 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  Card fresh;
  Card& c = dev < 64 ? cached[dev] : fresh;
  if (c.sms == 0) {
    int threads = 0;
    cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    c.warps_per_sm = max(threads / 32, 1);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    c.sms = max(c.sms, 1);
  }
  return c;
}

template <int WPQ, int VW>
int launch_dense(const int32_t* out, const int32_t* in, int32_t* hits,
                 int32_t* hub, int q_n, int l_n, int sms, cudaStream_t s) {
  static int per_sm = 0;   // blocks of this instance a SM holds at once
  if (per_sm == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, label_join_kernel<WPQ, VW>, B8_THREADS, 0);
    per_sm = max(n, 1);
  }
  constexpr int QPB = B8_THREADS / (32 * WPQ);
  const long long need = (static_cast<long long>(q_n) + QPB - 1) / QPB;
  const long long resident = static_cast<long long>(per_sm) * sms;
  label_join_kernel<WPQ, VW>
      <<<static_cast<unsigned>(min(need, resident)), B8_THREADS, 0, s>>>(
          out, in, q_n, l_n, hits, hub);
  return static_cast<int>(cudaGetLastError());
}

template <int VW>
int launch_dense_by_q(const int32_t* out, const int32_t* in, int32_t* hits,
                      int32_t* hub, int q_n, int l_n, cudaStream_t s) {
  // the most warps a query at which all Q * WPQ warps fit on the card at
  // once: the fewest loads a thread, so the fewest round trips
  const Card c = card();
  const long long room = static_cast<long long>(c.warps_per_sm) * c.sms;
  int wpq = 8;
  while (wpq > 1 && static_cast<long long>(q_n) * wpq > room) wpq >>= 1;
  switch (wpq) {
    case 8:
      return launch_dense<8, VW>(out, in, hits, hub, q_n, l_n, c.sms, s);
    case 4:
      return launch_dense<4, VW>(out, in, hits, hub, q_n, l_n, c.sms, s);
    case 2:
      return launch_dense<2, VW>(out, in, hits, hub, q_n, l_n, c.sms, s);
    default:
      return launch_dense<1, VW>(out, in, hits, hub, q_n, l_n, c.sms, s);
  }
}

unsigned blocks_for(int q_n) {
  return static_cast<unsigned>((q_n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

}  // namespace

extern "C" int label_join_packed_launch(const void* out, const void* in,
                                        void* hits, void* hub, int q_n,
                                        int w_n, void* stream) {
  if (q_n <= 0) return 0;
  label_join_packed_kernel<<<blocks_for(q_n), WARPS_PER_BLOCK * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(out), static_cast<const uint32_t*>(in),
      q_n, w_n, static_cast<int32_t*>(hits), static_cast<int32_t*>(hub));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int label_join_slots_launch(const void* out_label,
                                       const void* in_label,
                                       const void* alive, const void* src,
                                       const void* dst, void* hits, void* hub,
                                       void* src_ok, void* dst_ok, int q_n,
                                       int w_n, int v_n, void* stream) {
  if (q_n <= 0) return 0;
  label_join_slots_kernel<<<blocks_for(q_n), WARPS_PER_BLOCK * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(out_label),
      static_cast<const uint32_t*>(in_label),
      static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dst), q_n, w_n, v_n,
      static_cast<int32_t*>(hits), static_cast<int32_t*>(hub),
      static_cast<uint8_t*>(src_ok), static_cast<uint8_t*>(dst_ok));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int label_join_launch(const void* out, const void* in, void* hits,
                                 void* hub, int q_n, int l_n, void* stream) {
  if (q_n <= 0) return 0;
  const auto* a = static_cast<const int32_t*>(out);
  const auto* b = static_cast<const int32_t*>(in);
  auto* h = static_cast<int32_t*>(hits);
  auto* u = static_cast<int32_t*>(hub);
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte loads pair OUT and IN chunks only where both rows sit at the
  // same address modulo 16
  const bool paired = ((reinterpret_cast<uintptr_t>(out) -
                        reinterpret_cast<uintptr_t>(in)) & 15u) == 0;
  return paired ? launch_dense_by_q<4>(a, b, h, u, q_n, l_n, s)
                : launch_dense_by_q<1>(a, b, h, u, q_n, l_n, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
