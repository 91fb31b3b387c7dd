"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin). Pattern
(rec, rec, local-attn) tiled over 38 blocks (12 triples + 2 recurrent);
MQA kv=1, window 2048; RG-LRU state is constant-size -> runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn_local"),
    lru_width=4096,
    mlp_act="gelu",
    source="arXiv:2402.19427; unverified",
)
