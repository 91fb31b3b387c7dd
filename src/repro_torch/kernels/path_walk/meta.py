"""KERNEL_META for the path_walk package — checked by the kernel-shape
sanitizer (``python -m repro_torch.analysis``, DESIGN.md §15) against
kernel.cu, ops.py and ref.py, and by ``chip_smoke.py`` against the
build's ``ptxas -v`` report.

Pure literal by contract (``ast.literal_eval`` is the parser). One thread
walks one query's chain of dependent loads; the kernel keeps no shared
memory. ``out`` is filled with -1 before the launch, which writes only
the flag, the length and the keys of each row.
"""

KERNEL_META = {
    "package": "path_walk",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "path_walk_launch": {
            "constants": {"THREADS": 64},
            "c_args": 10,
            "operands": {
                "parent": {"dtype": "int32", "shape": ["q", "v"]},
                "found": {"dtype": "bool", "shape": ["q"]},
                "src_slot": {"dtype": "int32", "shape": ["q"]},
                "dst_slot": {"dtype": "int32", "shape": ["q"]},
                "vkey": {"dtype": "int32", "shape": ["v"]},
            },
            "outputs": {
                "out": {"dtype": "int32", "shape": ["q", "2 + cap"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "path_walk",
            "ref": "path_walk_ref",
        },
    },
    "device_kernels": {
        "walk_paths": {"static_smem_bytes": 0},
    },
}
