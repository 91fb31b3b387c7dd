"""KERNEL_META of the consistent fixture package: every check passes.

Drifted copy of kernel_pkg_ok: toy_ref takes n as a second operand and no `wide` option."""

KERNEL_META = {
    "package": "kernel_ref_arity",
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
            "max_registers": 128,
            "instances": {"<false>": {}, "<true>": {}},
        },
    },
}
