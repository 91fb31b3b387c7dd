// B3: one packed top-down BFS superstep for a single frontier, and B7: its
// dense form over a uint8 adjacency, on sm_90a.
// B3 replaces repro/kernels/bfs_step/kernel.py::bfs_step_packed_pallas; it
// is the Q = 1 instance of the B1 push (../bfs_multi_step/push.cuh): with
// one query the split form spreads the frontier rows over the card's SMs.
// B7 replaces repro/kernels/bfs_step/kernel.py::bfs_step_pallas, the Q = 1
// instance of the B6 dense push (../bfs_multi_step/dense.cuh).
#include "../bfs_multi_step/dense.cuh"
#include "../bfs_multi_step/push.cuh"

extern "C" int bfs_step_packed_launch(const void* frontier, const void* adj,
                                      const void* alive, const void* visited,
                                      void* new_out, void* parent, void* reach,
                                      void* fw, int v_n, int w_n,
                                      void* stream) {
  return static_cast<int>(push::launch(frontier, adj, alive, visited, new_out,
                                       parent, reach, fw, 1, v_n, w_n, v_n, 1,
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
