"""mamba2-780m [ssm] — arXiv:2405.21060 (SSD). Attention-free; constant-size
state -> runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    source="arXiv:2405.21060; unverified",
)
