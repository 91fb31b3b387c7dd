"""olmo-1b [dense] — arXiv:2402.00838; non-parametric LayerNorm, MHA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=50304,
    parametric_norm=False,
    norm_type="layernorm",
    skip_shapes=("long_500k",),
    source="arXiv:2402.00838; hf",
)
