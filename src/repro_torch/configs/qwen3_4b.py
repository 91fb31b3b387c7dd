"""qwen3-4b [dense] — hf:Qwen/Qwen3-8B family; qk_norm, GQA. Full attention."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
    source="hf:Qwen/Qwen3-8B; hf",
)
