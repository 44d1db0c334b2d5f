"""Model/run configuration system.

``ModelConfig`` is a frozen dataclass covering every family of the model
zoo (dense / moe / ssm / hybrid / audio / vlm). Each architecture module in
this package exports ``CONFIG`` (exact published numbers) and
``smoke_config()`` (reduced same-family config for CPU tests). The registry
(:func:`get_config`) resolves ``--arch <id>`` names.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ModelConfig", "get_config", "smoke_config", "ARCH_IDS"]

ARCH_IDS = [
    "zamba2-2.7b",
    "musicgen-large",
    "llama3-405b",
    "qwen3-14b",
    "granite-34b",
    "command-r-35b",
    "mamba2-370m",
    "granite-moe-3b-a800m",
    "moonshot-v1-16b-a3b",
    "qwen2-vl-72b",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1.0e4
    m_rope: bool = False           # qwen2-vl M-RoPE (3-D sections)
    m_rope_sections: tuple = (16, 24, 24)   # t/h/w split of head_dim//2
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    # --- hybrid (zamba2): shared attention block every k ssm blocks ---
    hybrid_attn_every: int = 0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # pad the expert dim so it divides the model axis (expert parallelism):
    # dummy experts get -inf router logits and zero traffic. granite's 40
    # experts pad to 48 (48 % 16 == 0) — see EXPERIMENTS.md §Perf iter 3.
    moe_pad_experts: int = 0
    # --- modality frontend ---
    frontend: str = "tokens"       # "tokens" | "embeddings" (audio/vlm stub)
    tie_embeddings: bool = False
    norm_eps: float = 1.0e-5
    max_position: int = 1 << 20

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim",
                self.d_model // self.num_heads if self.num_heads else 0)

    # -- derived ------------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the vocab-parallel embedding/head shard
        evenly over the model axis (padding ids are masked to -inf in the
        head; labels never reference them)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def num_experts_padded(self) -> int:
        return max(self.moe_pad_experts, self.num_experts)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def num_attn_layers(self) -> int:
        """Distinct attention-cache application points."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // max(self.hybrid_attn_every, 1)
        return self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hq = self.num_heads * (self.head_dim or 0)
        hkv = self.num_kv_heads * (self.head_dim or 0)
        attn = d * hq + 2 * d * hkv + hq * d
        mlp = 3 * d * f
        n = 0
        if self.family in ("dense", "audio", "vlm"):
            n = self.num_layers * (attn + mlp + 2 * d)
        elif self.family == "moe":
            n = self.num_layers * (attn + 2 * d + d * self.num_experts
                                   + self.num_experts * 3 * d * f)
        elif self.family in ("ssm", "hybrid"):
            din = self.ssm_d_inner
            nh = self.ssm_num_heads
            g = self.ssm_groups
            in_proj = d * (2 * din + 2 * g * self.ssm_state + nh)
            conv = (din + 2 * g * self.ssm_state) * self.ssm_conv_width
            out_proj = din * d
            per_ssm = in_proj + conv + out_proj + 2 * nh + din + d
            n = self.num_layers * per_ssm
            if self.family == "hybrid":
                n += self.num_attn_layers * 0 + (attn + mlp + 2 * d)  # shared
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        if self.frontend == "embeddings":
            emb = 0
        return n + emb + head + d

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() \
            - self.num_layers * self.num_experts * 3 * d * f
        return dense_like + self.num_layers * self.experts_per_token * 3 * d * f


_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "musicgen-large": "musicgen_large",
    "llama3-405b": "llama3_405b",
    "qwen3-14b": "qwen3_14b",
    "granite-34b": "granite_34b",
    "command-r-35b": "command_r_35b",
    "mamba2-370m": "mamba2_370m",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "moonshot-v1-16b-a3b": "moonshot_16b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch '{arch}' (have {sorted(_MODULES)})")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
