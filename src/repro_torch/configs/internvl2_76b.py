"""internvl2-76b [vlm] — arXiv:2404.16821. Transformer BACKBONE only
(InternLM2/Llama3-70B-class); the InternViT frontend is a STUB:
input_specs() supplies 256 precomputed patch embeddings prepended to the
text sequence. Full attention -> long_500k skipped."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    n_vis_tokens=256,
    tie_embeddings=False,
    skip_shapes=("long_500k",),
    source="arXiv:2404.16821; unverified",
)
