"""Architecture and shape configuration schema (a copy of `repro.configs.base`).

Every assigned architecture is a frozen `ArchConfig`; every workload shape a
`ShapeConfig`.  A (config, shape) pair fully determines the program the
launcher lowers — `train_step` for training shapes, `serve_step` (one-token
decode against a KV cache / recurrent state) for decode shapes, `prefill`
for prefill shapes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention flavor
    attention: str = "full"     # full | swa | mla | none
    window: int = 4096          # sliding-window size (attention == "swa")
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mlp_kind: str = "swiglu"    # swiglu | gelu

    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading layers with a dense MLP
    capacity_factor: float = 1.25

    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    block_unit: Tuple[str, ...] = ()   # repeating block-kind pattern, e.g.
                                       # ("mlstm","mlstm","mlstm","slstm")

    # modality frontend (stub: input_specs provides embeddings directly)
    frontend: str = "none"      # none | audio | vision

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""            # provenance tag [arXiv/hf; tier]

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_recurrent(self) -> bool:
        """True when decode state is O(1) in sequence length."""
        return self.family in ("ssm",) or bool(self.block_unit)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling: SSM/recurrent or SWA."""
        return self.is_recurrent or self.attention == "swa" or \
            self.family == "hybrid"

    @property
    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, expanded from the repeating unit."""
        if self.block_unit:
            unit = self.block_unit
            reps = math.ceil(self.n_layers / len(unit))
            return tuple((unit * reps)[: self.n_layers])
        if self.family == "hybrid":
            return ("hybrid",) * self.n_layers
        return ("attn",) * self.n_layers

    def param_count(self) -> float:
        """Analytical parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_size * d   # embedding
        if not self.tie_embeddings:
            total += d * self.vocab_size  # head
        for kind in self.block_kinds:
            total += 2 * d  # norms
            if kind == "attn" or kind == "hybrid":
                if self.attention == "mla":
                    qk = self.qk_nope_head_dim + self.qk_rope_head_dim
                    q_in = self.q_lora_rank or d
                    total += (d * self.q_lora_rank if self.q_lora_rank else 0)
                    total += q_in * self.n_heads * qk
                    total += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * hd          # q
                    total += 2 * d * self.n_kv_heads * hd   # k, v
                    total += self.n_heads * hd * d          # o
            if kind == "hybrid" or kind == "ssm":
                d_in = self.ssm_expand * d
                total += d * 2 * d_in + d_in * d            # in/out proj
                total += d_in * 2 * self.ssm_state + d_in   # B,C,dt
            if kind == "mlstm":
                d_in = 2 * d
                total += d * 2 * d_in + d_in * d
                total += 3 * d_in                            # i,f,o gates
            if kind == "slstm":
                total += 4 * d * d + 4 * d                   # 4 gates
                total += int(d * (4 / 3) * d) * 2            # ffn
            # FFN
            if kind in ("attn", "hybrid", "ssm"):
                is_moe = self.n_experts > 0
                if is_moe:
                    ff = self.moe_d_ff or self.d_ff
                    n_mats = 3 if self.mlp_kind == "swiglu" else 2
                    total += d * self.n_experts  # router
                    total += self.n_experts * n_mats * d * ff
                    total += self.n_shared_experts * n_mats * d * ff
                elif self.d_ff > 0:
                    n_mats = 3 if self.mlp_kind == "swiglu" else 2
                    total += n_mats * d * self.d_ff
        return float(total)

    def active_param_count(self) -> float:
        """Activated parameters per token (MoE top-k instead of all-E)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        ff = self.moe_d_ff or self.d_ff
        n_mats = 3 if self.mlp_kind == "swiglu" else 2
        n_moe_layers = sum(1 for k in self.block_kinds
                           if k in ("attn", "hybrid", "ssm")) \
            - self.first_dense_layers
        inactive = n_moe_layers * (self.n_experts - self.top_k) * \
            n_mats * self.d_model * ff
        return float(full - inactive)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The shape set for an arch; long_500k only for sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens/step.

    For non-train shapes the forward-only factor is 2*N instead of 6*N.
    """
    n = cfg.active_param_count()
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n * shape.tokens_per_step


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    unit = cfg.block_unit
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, len(unit) or 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.attention == "mla" else cfg.qk_nope_head_dim,
        qk_rope_head_dim=8 if cfg.attention == "mla" else cfg.qk_rope_head_dim,
        v_head_dim=16 if cfg.attention == "mla" else cfg.v_head_dim,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        window=64 if cfg.attention == "swa" else cfg.window,
        first_dense_layers=min(cfg.first_dense_layers, 1),
    )
