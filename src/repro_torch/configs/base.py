"""Architecture config schema + the assigned input-shape sets: the port's
own copy of ``repro.configs.base`` (plain Python, no framework), field for
field the same.

Every assigned architecture gets a module ``configs/<id>.py`` exporting
``CONFIG`` (exact published numbers) — selectable via ``--arch <id>`` in the
launchers. ``CONFIG.smoke()`` returns the family-preserving reduced config
used by per-arch CPU smoke tests (small widths, few layers/experts).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


# The LM shape set (seq_len, global_batch) — identical for all 10 archs.
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    head_dim: int = 0            # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab: int = 512
    # attention options
    rope_theta: float = 10_000.0
    qk_norm: bool = False        # qwen3: per-head RMSNorm on q, k
    qkv_bias: bool = False       # qwen2
    attn_softcap: float = 0.0    # gemma2: 50.0 (0 = off)
    final_softcap: float = 0.0   # gemma2: 30.0
    sliding_window: int = 0      # 0 = global; gemma2: 4096, recurrentgemma: 2048
    local_global_period: int = 0  # gemma2: 2 (alternate local/global)
    query_scale: float = 0.0     # 0 => 1/sqrt(head_dim); gemma2-27b: 1/sqrt(144)
    # norm / mlp
    norm_eps: float = 1e-6
    parametric_norm: bool = True  # olmo: False (non-parametric LN)
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    sandwich_norm: bool = False   # gemma2 post-norms
    mlp_act: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    router_aux_coef: float = 0.01
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (recurrentgemma / Griffin): pattern of block kinds, tiled
    block_pattern: tuple = ()     # e.g. ("rec", "rec", "attn")
    lru_width: int = 0            # 0 => d_model
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500        # stub conv frontend output length
    # vlm
    n_vis_tokens: int = 0         # stub patch embeddings prepended (internvl2)
    # numerics
    dtype: str = "bfloat16"
    # which shape cells are runnable; long_500k excluded for full attention
    skip_shapes: tuple = ()
    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_lru(self) -> int:
        return self.lru_width or self.d_model

    def smoke(self) -> "ArchConfig":
        """Family-preserving reduced config for CPU smoke tests."""
        pattern = self.block_pattern[: len(self.block_pattern) or None]
        return replace(
            self,
            n_layers=max(2, len(pattern) or 2) if self.family != "encdec" else 2,
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 4) if self.n_kv > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_ff=32 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            lru_width=64 if self.lru_width else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=24 if self.enc_layers else 1500,
            n_vis_tokens=4 if self.n_vis_tokens else 0,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.hd
        qdim, kvdim = self.n_heads * hd, self.n_kv * hd
        attn = d * qdim + 2 * d * kvdim + qdim * d
        if self.family == "ssm":
            din = self.ssm_expand * d
            nh = din // self.ssm_headdim
            per = d * (2 * din + 2 * self.ssm_state + nh) + din * d + din * self.ssm_conv + 2 * nh
            body = self.n_layers * (per + d)
        elif self.family == "hybrid":
            per_attn = attn + 3 * d * self.d_ff + 2 * d
            dl = self.d_lru
            per_rec = d * dl * 2 + dl * d + dl * self.ssm_conv + 4 * dl + 3 * d * self.d_ff + 2 * d
            pat = self.block_pattern or ("rec",)
            n_attn = sum(1 for i in range(self.n_layers) if pat[i % len(pat)] == "attn")
            body = n_attn * per_attn + (self.n_layers - n_attn) * per_rec
        else:
            if self.n_experts:
                ffn = self.n_experts * 3 * d * self.expert_ff + d * self.n_experts
            else:
                ffn = 3 * d * self.d_ff
            body = self.n_layers * (attn + ffn + 2 * d)
            if self.enc_layers:
                body += self.enc_layers * (attn + 3 * d * self.d_ff + 2 * d)
                body += self.n_layers * (attn + 2 * d)  # cross attention
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return body + emb + d

    def active_param_count(self) -> int:
        """N_active for MoE (6*N_active*D)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_ffn = self.n_layers * (self.top_k * 3 * d * self.expert_ff + d * self.n_experts)
        all_ffn = self.n_layers * (self.n_experts * 3 * d * self.expert_ff + d * self.n_experts)
        return self.param_count() - all_ffn + dense_ffn


def shape_for(name: str) -> dict:
    return dict(SHAPES[name])
