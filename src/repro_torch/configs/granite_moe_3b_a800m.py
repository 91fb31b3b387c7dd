"""granite-moe-3b-a800m [moe] — hf:ibm-granite; 40 experts top-8.

Assignment line also says "(32 experts top-8)" parenthetically; we follow the
primary "MoE 40e top-8" spec (matches the published granite-3.0-3b-a800m).
Full attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    expert_ff=512,
    skip_shapes=("long_500k",),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
