"""KERNEL_META for the edge_update package (B5 and B9) — checked by the
kernel-shape sanitizer (``python -m repro_torch.analysis``, DESIGN.md §15)
against kernel.cu, ops.py and ref.py, and by ``chip_smoke.py`` against
the build's ``ptxas -v`` report.

Pure literal by contract (``ast.literal_eval`` is the parser). The
wrappers launch the ``*_scratch_launch`` entry points; the one-block
``edge_update_launch`` / ``edge_update_packed_launch`` stay in the C
interface with no ops.py caller (``"wrapper": None``). The packed form's
padding story is ``"mask"``: each firing lane sets or clears one bit
through a shifted mask, so the padding bits of a word are never written.
``one_block`` keeps its hash table in dynamic shared memory.
"""

KERNEL_META = {
    "package": "edge_update",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "edge_update_scratch_launch": {
            "constants": {"ONE_BLOCK_LANES": 2048,
                          "ONE_BLOCK_THREADS": 1024, "WIDE_THREADS": 256,
                          "SLOT_BYTES": 12},
            "c_args": 11,
            "operands": {
                "adj": {"dtype": "uint8", "shape": ["n_rows", "n_cols"]},
                "ecnt": {"dtype": "int32", "shape": ["n_rows"]},
                "rows": {"dtype": "int32", "shape": ["b"]},
                "cols": {"dtype": "int32", "shape": ["b"]},
                "vals": {"dtype": "int32", "shape": ["b"]},
                "mask": {"dtype": "int32", "shape": ["b"]},
            },
            "outputs": {
                "scratch": {"dtype": "uint8", "shape": ["nbytes"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "edge_update",
            "ref": "edge_update_ref",
        },
        "edge_update_packed_scratch_launch": {
            "constants": {"ONE_BLOCK_LANES": 2048,
                          "ONE_BLOCK_THREADS": 1024, "WIDE_THREADS": 256,
                          "SLOT_BYTES": 12},
            "c_args": 11,
            "operands": {
                "adj": {"dtype": "int32", "shape": ["n_rows", "n_cols"]},
                "ecnt": {"dtype": "int32", "shape": ["n_rows"]},
                "rows": {"dtype": "int32", "shape": ["b"]},
                "cols": {"dtype": "int32", "shape": ["b"]},
                "vals": {"dtype": "int32", "shape": ["b"]},
                "mask": {"dtype": "int32", "shape": ["b"]},
            },
            "outputs": {
                "scratch": {"dtype": "uint8", "shape": ["nbytes"]},
            },
            "packed": True,
            "pad_safety": "mask",
            "wrapper": "edge_update_packed",
            "ref": "edge_update_packed_ref",
        },
        "edge_update_launch": {
            "constants": {"ONE_BLOCK_LANES": 2048,
                          "ONE_BLOCK_THREADS": 1024, "SLOT_BYTES": 12},
            "c_args": 10,
            "wrapper": None,
        },
        "edge_update_packed_launch": {
            "constants": {"ONE_BLOCK_LANES": 2048,
                          "ONE_BLOCK_THREADS": 1024, "SLOT_BYTES": 12},
            "c_args": 10,
            "wrapper": None,
        },
    },
    "device_kernels": {
        "one_block": {
            "static_smem_bytes": 0,
            # SLOT_BYTES << log2_slots(lanes): at most 2 x lanes slots
            "dynamic_smem": "SLOT_BYTES * 2 * ONE_BLOCK_LANES",
            "dynamic_smem_bytes": 49152,
            "instances": {"<false>": {}, "<true>": {}},
        },
        "wide_clear": {"static_smem_bytes": 0},
        "wide_claim": {"static_smem_bytes": 0},
        "wide_apply": {
            "static_smem_bytes": 0,
            "instances": {"<false>": {}, "<true>": {}},
        },
    },
}
