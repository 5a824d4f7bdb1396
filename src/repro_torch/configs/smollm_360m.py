"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152; llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="smollm-tiny",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        scan_layers=False,
        attn_chunk=64,
    )
