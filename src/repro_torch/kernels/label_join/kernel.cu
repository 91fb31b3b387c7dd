// B4 and B8: batched 2-hop label joins, on sm_90a.
// B4 replaces repro/kernels/label_join/kernel.py::label_join_packed_pallas,
// B8 replaces repro/kernels/label_join/kernel.py::label_join_pallas.
//
// Contract (words = int32 bit patterns read as uint32):
//   B4 packed: out, in int32[Q, W] label bitsets   (bit l of word l/32)
//   B8 dense:  out, in int32[Q, L] 0/1 label slabs (nonzero = set)
//   -> hits int32[Q]  number of landmarks set in both rows of query q
//      hub  int32[Q]  smallest such landmark, -1 when there is none
//
// What bounds it: the bytes of the two label rows per query (2 * W * 4 for
// B4, 2 * L * 4 for B8) plus 8 bytes of output; at the index's Q = 64 and
// W = 32 that is 16 KB, so one launch is bound by its launch latency, not
// by the card. The design is the simplest that reads each word once,
// coalesced:
//   * one warp per query; lane j reads words j, j + 32, ... of both rows
//     (at L = 1,024 one word per lane), so a warp's loads are contiguous;
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

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
label_join_kernel(const int32_t* __restrict__ out,
                  const int32_t* __restrict__ in, int q_n, int l_n,
                  int32_t* __restrict__ hits_out,
                  int32_t* __restrict__ hub_out) {
  const int q = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= q_n) return;  // whole warp
  const int32_t* a = out + static_cast<size_t>(q) * l_n;
  const int32_t* b = in + static_cast<size_t>(q) * l_n;
  int hits = 0;
  int32_t hub = NO_HUB;
  for (int l = lane; l < l_n; l += 32) {
    if (a[l] == 0) continue;  // no OUT label: no IN read
    if (b[l] != 0) {
      ++hits;
      if (hub == NO_HUB) hub = l;
    }
  }
  warp_finish(hits, hub, q, lane, hits_out, hub_out);
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
  label_join_kernel<<<blocks_for(q_n), WARPS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(out), static_cast<const int32_t*>(in), q_n,
      l_n, static_cast<int32_t*>(hits), static_cast<int32_t*>(hub));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
