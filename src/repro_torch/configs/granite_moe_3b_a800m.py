"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]

The paper's own organization (IBM) — the natural "paper's technique" MoE.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        n_experts=40,
        top_k=8,
        moe_d_ff=512,
        tie_embeddings=True,
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="granite-moe-tiny",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        moe_d_ff=64,
        n_experts=5,
        top_k=2,
        vocab_size=256,
        scan_layers=False,
        attn_chunk=64,
    )
