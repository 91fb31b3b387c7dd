// B1: one packed top-down BFS superstep for Q frontiers, and B6: its dense
// form over a uint8 adjacency, on sm_90a.
// B1 replaces repro/kernels/bfs_multi_step/kernel.py::multi_bfs_step_packed_pallas
// (kernels and design notes in push.cuh); B6 replaces
// repro/kernels/bfs_multi_step/kernel.py::multi_bfs_step_pallas (dense.cuh).
#include "dense.cuh"
#include "push.cuh"

extern "C" int multi_bfs_step_packed_launch(
    const void* frontier, const void* adj, const void* alive,
    const void* visited, void* new_out, void* parent, void* reach, void* fw,
    int q_n, int r_n, int w_n, int v_n, int parents, void* stream) {
  return static_cast<int>(push::launch(frontier, adj, alive, visited, new_out,
                                       parent, reach, fw, q_n, r_n, w_n, v_n,
                                       parents,
                                       static_cast<cudaStream_t>(stream)));
}

extern "C" int multi_bfs_step_launch(const void* frontier, const void* adj,
                                     const void* alive, const void* visited,
                                     void* new_out, void* parent, void* qm,
                                     void* scratch, int q_n, int r_n, int v_n,
                                     int parents, void* stream) {
  return static_cast<int>(dense::launch(frontier, adj, alive, visited,
                                        new_out, parent, qm, scratch, q_n,
                                        r_n, v_n, parents,
                                        static_cast<cudaStream_t>(stream)));
}
