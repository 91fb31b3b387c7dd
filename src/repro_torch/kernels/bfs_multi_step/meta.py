"""KERNEL_META for the bfs_multi_step package (B1 and B6) — checked by
the kernel-shape sanitizer (``python -m repro_torch.analysis``, DESIGN.md
§15) against kernel.cu, push.cuh, dense.cuh, ops.py and ref.py, and by
``chip_smoke.py`` against the build's ``ptxas -v`` report.

Pure literal by contract (``ast.literal_eval`` is the parser). B1's
constants live in ``namespace push``, B6's in ``namespace dense``
(``dense::UNROLL`` is a template variable: 4 rows in flight with parents,
8 without). ``dense_push`` takes its tile in dynamic shared memory (at
most 67,584 bytes with parents, 4,096 without); its ``__launch_bounds__``
ask for 3 blocks an SM with parents (so 80 registers; 3 x (67,584 +
1,024) bytes fit the SM's 233,472) and 2 without (128). ``dense_compact`` declares 36 bytes of
``__shared__`` and ptxas lays them out in 48 (``warp_off`` 16-byte
aligned after ``block_off``).
"""

KERNEL_META = {
    "package": "bfs_multi_step",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "multi_bfs_step_packed_launch": {
            "constants": {"push::SCAN_THREADS": 128,
                          "push::TILE_COLS": 4096, "push::SPLIT_WORDS": 64,
                          "push::SUBS": 4, "push::GROUP": 32,
                          "push::PREFETCH": 8, "push::MIN_BLOCKS": 528},
            "c_args": 14,
            "operands": {
                "frontiers": {"dtype": "bool", "shape": ["q", "rows"]},
                "adj_packed": {"dtype": "int32", "shape": ["rows", "w"]},
                "alive": {"dtype": "bool", "shape": ["v"]},
                "visited": {"dtype": "bool", "shape": ["q", "v"]},
            },
            "outputs": {
                "new": {"dtype": "bool", "shape": ["q", "v"]},
                "parent": {"dtype": "int32", "shape": ["q", "v"]},
                "reach": {"dtype": "int32", "shape": ["q", "w"]},
                "scratch": {"dtype": "int32",
                            "shape": ["q", "-(-rows // 32)"]},
            },
            "packed": True,
            "pad_safety": "mask",
            "wrapper": "multi_bfs_step_packed_kernel",
            "ref": "multi_bfs_step_packed_ref",
        },
        "multi_bfs_step_launch": {
            "constants": {"dense::GROUP": 64, "dense::MASK_ROWS": 256,
                          "dense::SLICE": 256, "dense::CHUNK": 16,
                          "dense::PUSH_THREADS": 256,
                          "dense::UNROLL": {"<true>": 4, "<false>": 8}},
            "c_args": 13,
            "operands": {
                "frontiers": {"dtype": "bool", "shape": ["q", "rows"]},
                "adj": {"dtype": "uint8", "shape": ["rows", "v"]},
                "alive": {"dtype": "bool", "shape": ["v"]},
                "visited": {"dtype": "bool", "shape": ["q", "v"]},
            },
            "outputs": {
                "new": {"dtype": "bool", "shape": ["q", "v"]},
                "parent": {"dtype": "int32", "shape": ["q", "v"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "multi_bfs_step",
            "ref": "multi_bfs_step_ref",
        },
    },
    "device_kernels": {
        "push::pack_frontier": {
            "static_smem_bytes": 0,
            "instances": {"<false>": {}, "<true>": {}},
        },
        "push::push_group": {"static_smem_bytes": 16384,
                             "min_blocks_per_sm": 2, "max_registers": 64},
        "push::init_outputs": {"static_smem_bytes": 0},
        "push::push_scan": {
            "static_smem_bytes": 0,
            "instances": {"<false>": {}, "<true>": {}},
        },
        "push::push_epilogue": {
            "static_smem_bytes": 0,
            "instances": {"<false>": {}, "<true>": {}},
        },
        "dense::dense_masks": {"static_smem_bytes": 32},
        "dense::dense_compact": {"static_smem_bytes": 36,
                                 "ptxas_smem_bytes": 48},
        "dense::dense_push": {
            "static_smem_bytes": 0,
            "instances": {
                "<false>": {"min_blocks_per_sm": 2, "max_registers": 128,
                            "dynamic_smem": "SLICE * 16",
                            "dynamic_smem_bytes": 4096},
                # SLICE * 8 + min(Q, GROUP) * SLICE * 4, at Q >= GROUP
                "<true>": {"min_blocks_per_sm": 3, "max_registers": 80,
                           "dynamic_smem": "SLICE * 8 + GROUP * SLICE * 4",
                           "dynamic_smem_bytes": 67584},
            },
        },
    },
}
