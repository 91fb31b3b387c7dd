// GetPath's path walk on sm_90a: every query's parent chain from its
// destination back to its source, and the keys of the slots on it, in one
// launch. Replaces no Pallas kernel: the JAX package walks each path with
// a lax.while_loop (repro/core/bfs.py::extract_path) and gathers the keys
// in the session; the port's plain version is path_walk_ref in ref.py,
// which this kernel matches bit for bit.
//
// Contract:
//   parent int32[Q, V]   each query's BFS forest (-1: no parent)
//   found bool[Q]   src, dst int32[Q]   the pair's answer and endpoint slots
//   vkey int32[V]   the slot keys
//   out int32[Q, 2 + cap], filled with -1 by the caller
// Row q of ``out`` gets found[q] in column 0 and the path's
// length n in column 1 (0 where found[q] is false), then the keys of its
// first min(n, cap) slots in source-to-destination order; the rest of the
// row is left as it is. The walk is extract_path's: from cur = dst, the
// next slot is -1 if cur == src, else parent[q, cur]; it stops at a
// negative slot or after V slots. A slot outside [0, V) also stops it,
// where the host walk would raise (no BFS forest holds one).
//
// What bounds it: latency. A hop is a load whose address is the previous
// load's value, so a query's walk is a chain of dependent loads, one
// thread a query. The thread walks its chain twice: the first pass counts
// the slots, and the second, which finds the chain's lines in L1, writes
// each key at its place from the source, n - 1 - i for the i-th slot from
// the destination; keys past the cap are skipped. The bytes are a few
// hundred a query; offsets into ``parent`` are 64-bit (Q V passes 2^31 at
// V = 266,240 from Q = 8,066 on).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;   // queries a block

__global__ void __launch_bounds__(THREADS)
walk_paths(const int32_t* __restrict__ parent,
           const uint8_t* __restrict__ found,
           const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
           const int32_t* __restrict__ vkey, int32_t* __restrict__ out,
           int q_n, int v_n, int cap) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= q_n) return;
  const int32_t* par = parent + static_cast<size_t>(q) * v_n;
  int32_t* row = out + static_cast<size_t>(q) * (2 + cap);
  const bool f = found[q] != 0;
  int n = 0;
  if (f) {
    const int s = src[q];
    const int d = dst[q];
    for (int cur = d; cur >= 0 && cur < v_n && n < v_n; ++n)
      cur = cur == s ? -1 : __ldg(par + cur);
    int cur = d;
    for (int i = 0; i < n; ++i) {
      const int at = n - 1 - i;
      if (at < cap) row[2 + at] = __ldg(vkey + cur);
      cur = cur == s ? -1 : __ldg(par + cur);
    }
  }
  row[0] = f ? 1 : 0;
  row[1] = n;
}

}  // namespace

// The walk of q_n queries over a forest of v_n slots a query, each row
// holding 2 + cap words.
extern "C" int path_walk_launch(const void* parent, const void* found,
                                const void* src, const void* dst,
                                const void* vkey, void* out, int q_n, int v_n,
                                int cap, void* stream) {
  if (q_n <= 0) return 0;
  walk_paths<<<(q_n + THREADS - 1) / THREADS, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parent), static_cast<const uint8_t*>(found),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const int32_t*>(vkey), static_cast<int32_t*>(out), q_n,
      v_n, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
