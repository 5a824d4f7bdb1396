"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Qwen3 uses head_dim=128 (decoupled from d_model/n_heads) and QK-norm.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=151936,
        head_dim=128,
        n_experts=128,
        top_k=8,
        moe_d_ff=1536,
        qk_norm=True,
        rope_theta=1000000.0,
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="qwen3-moe-tiny",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        moe_d_ff=96,
        n_experts=8,
        top_k=2,
        vocab_size=256,
        scan_layers=False,
        attn_chunk=64,
    )
