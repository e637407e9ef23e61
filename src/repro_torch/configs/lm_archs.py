"""The 10 architectures, copied field for field from `repro.configs.lm_archs`.

The port keeps its own copy so it imports nothing of the JAX package;
`tests/test_torch_rules.py` holds the two tables equal so they cannot drift.
Each is a frozen `ArchConfig`; provenance in `source`.
"""
from .base import ArchConfig

XLSTM_125M = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, head_dim=192,
    attention="none",
    # xLSTM[7:1]-style mix: mostly mLSTM with periodic sLSTM blocks.
    block_unit=("mlstm", "mlstm", "mlstm", "slstm"),
    source="sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]",
)

QWEN2_0_5B = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, head_dim=64,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    source="GQA, QKV bias [arXiv:2407.10671; hf]",
)

H2O_DANUBE3_4B = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, head_dim=120,
    attention="swa", window=4096, rope_theta=1e4,
    source="llama+mistral mix, SWA [arXiv:2401.16818; unverified]",
)

GLM4_9B = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, head_dim=128, rope_theta=1e4,
    source="RoPE, GQA [hf:THUDM/glm-4-9b; hf]",
)

DEEPSEEK_CODER_33B = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab_size=32256, head_dim=128, rope_theta=1e5,
    source="llama-arch [arXiv:2401.14196; hf]",
)

HYMBA_1_5B = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_expand=2,
    attention="swa", window=1024,  # hymba uses SWA on most hybrid layers
    source="parallel attn+mamba heads [arXiv:2411.13676; hf]",
)

DEEPSEEK_V2_236B = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=12288,
    vocab_size=102400, head_dim=128,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    first_dense_layers=1,
    source="MLA kv_lora=512, 2 shared+160 routed top-6 [arXiv:2405.04434; hf]",
)

PHI35_MOE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, head_dim=128,
    n_experts=16, n_shared_experts=0, top_k=2, moe_d_ff=6400,
    source="16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]",
)

MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64,
    mlp_kind="gelu", frontend="audio",
    source="decoder-only over EnCodec tokens [arXiv:2306.05284; hf]",
)

INTERNVL2_2B = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, head_dim=128,
    frontend="vision",
    source="InternViT + InternLM2 [arXiv:2404.16821; hf]",
)

ALL_ARCHS = (
    XLSTM_125M, QWEN2_0_5B, H2O_DANUBE3_4B, GLM4_9B, DEEPSEEK_CODER_33B,
    HYMBA_1_5B, DEEPSEEK_V2_236B, PHI35_MOE, MUSICGEN_MEDIUM, INTERNVL2_2B,
)
