"""KERNEL_META for the label_join package (B4 and B8) — checked by the
kernel-shape sanitizer (``python -m repro_torch.analysis``, DESIGN.md §15)
against kernel.cu, ops.py and ref.py, and by ``chip_smoke.py`` against
the build's ``ptxas -v`` report.

Pure literal by contract (``ast.literal_eval`` is the parser). B4 reads
packed label words but writes dense (hits, hub) rows, so it has no
padding bits to protect (``packed: False``); zero padding bits add
neither hits nor hub candidates. ``label_join_kernel`` (B8) is built for
warps a query WPQ in {1, 2, 4, 8} and VW in {1, 4} entries a load; its
64 bytes of ``__shared__`` combine a query's warps, so the WPQ = 1
instances never touch them and ptxas gives them none.
"""

KERNEL_META = {
    "package": "label_join",
    "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
    "kernels": {
        "label_join_packed_launch": {
            "constants": {"WARPS_PER_BLOCK": 8},
            "c_args": 7,
            "operands": {
                "out": {"dtype": "int32", "shape": ["q", "n"]},
                "in": {"dtype": "int32", "shape": ["q", "n"]},
            },
            "outputs": {
                "hits": {"dtype": "int32", "shape": ["q"]},
                "hub": {"dtype": "int32", "shape": ["q"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "label_join_packed",
            "ref": "label_join_packed_ref",
        },
        "label_join_slots_launch": {
            "constants": {"WARPS_PER_BLOCK": 8},
            "c_args": 13,
            "operands": {
                "out_label": {"dtype": "int32", "shape": ["v", "w"]},
                "in_label": {"dtype": "int32", "shape": ["v", "w"]},
                "alive": {"dtype": "bool", "shape": ["v"]},
                "src": {"dtype": "int32", "shape": ["q"]},
                "dst": {"dtype": "int32", "shape": ["q"]},
            },
            "outputs": {
                "hits": {"dtype": "int32", "shape": ["q"]},
                "hub": {"dtype": "int32", "shape": ["q"]},
                "sok": {"dtype": "bool", "shape": ["q"]},
                "dok": {"dtype": "bool", "shape": ["q"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "label_join_slots",
            "ref": "label_join_slots_ref",
        },
        "label_join_launch": {
            "constants": {"B8_THREADS": 256, "B8_TILE": 1024},
            "c_args": 7,
            "operands": {
                "out": {"dtype": "int32", "shape": ["q", "n"]},
                "in": {"dtype": "int32", "shape": ["q", "n"]},
            },
            "outputs": {
                "hits": {"dtype": "int32", "shape": ["q"]},
                "hub": {"dtype": "int32", "shape": ["q"]},
            },
            "packed": False,
            "pad_safety": None,
            "wrapper": "label_join",
            "ref": "label_join_ref",
        },
    },
    "device_kernels": {
        "label_join_packed_kernel": {"static_smem_bytes": 0},
        "label_join_slots_kernel": {"static_smem_bytes": 0},
        "label_join_kernel": {
            "static_smem_bytes": 64,
            "instances": {
                "<1, 1>": {"ptxas_smem_bytes": 0},
                "<1, 4>": {"ptxas_smem_bytes": 0},
                "<2, 1>": {}, "<2, 4>": {}, "<4, 1>": {}, "<4, 4>": {},
                "<8, 1>": {}, "<8, 4>": {},
            },
        },
    },
}
