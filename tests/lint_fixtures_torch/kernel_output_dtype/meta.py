"""KERNEL_META of the consistent fixture package: every check passes.

Drifted copy of kernel_pkg_ok: ops.py allocates y as float32; meta.py says int32."""

KERNEL_META = {
    "package": "kernel_output_dtype",
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
