"""KERNEL_META for the bfs_step package (B3 and B7) — checked by the
kernel-shape sanitizer (``python -m repro_torch.analysis``, DESIGN.md §15)
against kernel.cu (and the bfs_multi_step headers it includes), ops.py
and ref.py, and by ``chip_smoke.py`` against the build's ``ptxas -v``
report.

Pure literal by contract (``ast.literal_eval`` is the parser). B3's
constants live in ``namespace single`` (``single::SLICE`` = 16 words a
block, not ``dense::SLICE``); B7 is the dense B6 superstep at Q = 1, so
its constants are ``dense::``'s. The device kernels of the included
headers are declared by bfs_multi_step, which owns them; this package
declares its own ``push_single``, whose ``Block`` struct takes 19,808
bytes of static shared memory.
"""

KERNEL_META = {
    "package": "bfs_step",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "bfs_step_packed_launch": {
            "constants": {"single::THREADS": 256, "single::SLICE": 16,
                          "single::COLS": 512, "single::UNROLL": 8,
                          "single::CLUSTER": 8, "single::SHARE": 320,
                          "single::PASS": 2560, "single::LIST": 4096},
            "c_args": 10,
            "operands": {
                "frontier": {"dtype": "bool", "shape": ["v"]},
                "adj_packed": {"dtype": "int32", "shape": ["v", "w"]},
                "alive": {"dtype": "bool", "shape": ["v"]},
                "visited": {"dtype": "bool", "shape": ["v"]},
            },
            "outputs": {
                "new": {"dtype": "bool", "shape": ["v"]},
                "parent": {"dtype": "int32", "shape": ["v"]},
                "reach": {"dtype": "int32", "shape": ["w"]},
            },
            "packed": True,
            "pad_safety": "mask",
            "wrapper": "bfs_step_packed_kernel",
            "ref": "bfs_step_packed_ref",
        },
        "bfs_step_launch": {
            "constants": {"dense::GROUP": 64, "dense::MASK_ROWS": 256,
                          "dense::SLICE": 256, "dense::CHUNK": 16,
                          "dense::PUSH_THREADS": 256,
                          "dense::UNROLL": {"<true>": 4, "<false>": 8}},
            "c_args": 10,
            "operands": {
                "frontier": {"dtype": "bool", "shape": ["v"]},
                "adj": {"dtype": "uint8", "shape": ["v", "v"]},
                "alive": {"dtype": "bool", "shape": ["v"]},
                "visited": {"dtype": "bool", "shape": ["v"]},
            },
            "outputs": {
                "new": {"dtype": "bool", "shape": ["v"]},
                "parent": {"dtype": "int32", "shape": ["v"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "bfs_step",
            "ref": "bfs_step_ref",
        },
    },
    "device_kernels": {
        "single::push_single": {"static_smem_bytes": 19808},
    },
}
