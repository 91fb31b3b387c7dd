"""KERNEL_META for the serial_pass package — checked by the kernel-shape
sanitizer (``python -m repro_torch.analysis``, DESIGN.md §15) against
kernel.cu, ops.py and ref.py, and by ``chip_smoke.py`` against the
build's ``ptxas -v`` report.

Pure literal by contract (``ast.literal_eval`` is the parser). The launch
writes the packed mirrors through shifted single-bit masks and zeroes
whole rows, so padding bits at columns >= V stay clear (``"mask"``). Its
scratch is zeroed (``torch.zeros``), not an output.
"""

KERNEL_META = {
    "package": "serial_pass",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "serial_pass_launch": {
            "constants": {"THREADS": 1024, "LOOKUPS": 3, "RING": 3,
                          "SCRATCH_INTS": 10},
            "c_args": 17,
            "operands": {
                "vkey": {"dtype": "int32", "shape": ["v"]},
                "valive": {"dtype": "bool", "shape": ["v"]},
                "vver": {"dtype": "int32", "shape": ["v"]},
                "ecnt": {"dtype": "int32", "shape": ["v"]},
                "adj_packed": {"dtype": "int32", "shape": ["v", "w"]},
                "adj_in_packed": {"dtype": "int32", "shape": ["v", "w"]},
                "opcode": {"dtype": "int32", "shape": ["b"]},
                "key1": {"dtype": "int32", "shape": ["b"]},
                "key2": {"dtype": "int32", "shape": ["b"]},
                "expect": {"dtype": "int32", "shape": ["b"]},
                "res": {"dtype": "int32", "shape": ["b"]},
                "mask": {"dtype": "bool", "shape": ["b"]},
            },
            "outputs": {},
            "packed": True,
            "pad_safety": "mask",
            "wrapper": "serial_pass",
            "ref": "serial_pass_ref",
        },
    },
    "device_kernels": {
        # red[LOOKUPS][WARPS] unsigned + found[LOOKUPS] int
        "serial_lanes": {"static_smem_bytes": 396},
    },
}
