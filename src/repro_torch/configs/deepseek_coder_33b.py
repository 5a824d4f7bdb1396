"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256; llama-arch. [arXiv:2401.14196]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        rope_theta=100000.0,
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="deepseek-coder-tiny",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        scan_layers=False,
        attn_chunk=64,
    )
