"""olmoe-1b-7b [moe] — arXiv:2409.02060; 64 experts top-8. Full attention."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    expert_ff=1024,
    qk_norm=True,
    skip_shapes=("long_500k",),
    source="arXiv:2409.02060; hf",
)
