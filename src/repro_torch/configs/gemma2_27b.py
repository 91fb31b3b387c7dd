"""gemma2-27b [dense] — arXiv:2408.00118. Local(4096)/global alternating,
attn/final logit softcaps, GeGLU, sandwich norms, query scale 1/sqrt(144).
Global layers are full attention -> long_500k skipped (DESIGN.md §5)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    query_scale=144.0 ** -0.5,
    sandwich_norm=True,
    mlp_act="gelu",
    skip_shapes=("long_500k",),
    source="arXiv:2408.00118; hf",
)
