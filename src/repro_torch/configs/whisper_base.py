"""whisper-base [audio] — arXiv:2212.04356. Enc-dec backbone; the conv audio
frontend is a STUB (input_specs supplies 1500 precomputed frame embeddings).
Full attention -> long_500k skipped; decode cells exercise the decoder."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    enc_layers=6,
    enc_frames=1500,
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_ff=2048,
    vocab=51865,
    mlp_act="gelu",
    norm_type="layernorm",
    skip_shapes=("long_500k",),
    source="arXiv:2212.04356; unverified",
)
