"""KERNEL_META for the bfs_pull_step package (B2) — checked by the
kernel-shape sanitizer (``python -m repro_torch.analysis``, DESIGN.md §15)
against kernel.cu, ops.py and ref.py, and by ``chip_smoke.py`` against the
build's ``ptxas -v`` report.

Pure literal by contract (``ast.literal_eval`` is the parser). H100
shared memory: 49152 = the 48 KB of static ``__shared__`` a block may
declare, 232448 = the 227 KB of dynamic shared memory a block may opt in
to. ``pull_rows`` takes 46,340 static bytes, so 4 blocks (its
``__launch_bounds__``) fit an SM, and the compiler caps it at 64
registers for them.
"""

KERNEL_META = {
    "package": "bfs_pull_step",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "bfs_pull_step_launch": {
            "constants": {"WARPS": 8, "THREADS": 256, "TILE": 32,
                          "LIST": 256, "MAX_WORDS": 65535, "UNROLL": 8,
                          "WALK": 8},
            "c_args": 12,
            "operands": {
                "frontier_words": {"dtype": "int32", "shape": ["q", "w"]},
                "adj_in_rows": {"dtype": "int32", "shape": ["rows", "w"]},
                "alive": {"dtype": "bool", "shape": ["rows"]},
                "visited": {"dtype": "bool", "shape": ["q", "rows"]},
            },
            "outputs": {
                "new": {"dtype": "bool", "shape": ["q", "rows"]},
                "parent": {"dtype": "int32", "shape": ["q", "rows"]},
                "scratch": {"dtype": "int32", "shape": ["w + q + w * q"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "bfs_pull_step_rows",
            "ref": "bfs_pull_step_ref",
        },
    },
    "device_kernels": {
        "transpose_frontier": {"static_smem_bytes": 4224},
        "pull_rows": {
            "static_smem_bytes": 46340,
            "min_blocks_per_sm": 4,
            "max_registers": 64,
            "instances": {"<false, false>": {}, "<false, true>": {},
                          "<true, false>": {}, "<true, true>": {}},
        },
    },
}
