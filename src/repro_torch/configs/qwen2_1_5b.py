"""qwen2-1.5b [dense] — arXiv:2407.10671; GQA kv=2, QKV bias. Full attention."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
    source="arXiv:2407.10671; hf",
)
