"""KERNEL_META of the consistent fixture package: every check passes.

Drifted copy of kernel_pkg_ok: meta.py declares 32,768 bytes of dynamic
shared memory, the launch requests 65,536."""

KERNEL_META = {
    "package": "kernel_dynamic_drift",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "toy_launch": {
            "constants": {"THREADS": 256, "TILE": 32, "toy::SLICE": 16,
                          "toy::UNROLL": {"<true>": 8, "<false>": 4}},
            "c_args": 5,
            "operands": {"x": {"dtype": "int32", "shape": ["n"]}},
            "outputs": {"y": {"dtype": "int32", "shape": ["n"]}},
            "packed": True,
            "pad_safety": "mask",
            "wrapper": "toy",
            "ref": "toy_ref",
        },
    },
    "device_kernels": {
        "toy_kernel": {
            "static_smem_bytes": 4384,
            "min_blocks_per_sm": 2,
            "dynamic_smem": "TILE * TILE * 64",
            "dynamic_smem_bytes": 32768,
            "max_registers": 128,
            "instances": {"<false>": {}, "<true>": {}},
        },
    },
}
