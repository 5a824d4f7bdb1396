"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention in a (rglru, rglru, attn) pattern.
[arXiv:2402.19427]

Local window 2048 + linear recurrence → sub-quadratic. Gemma-style
head_dim=256 (10 heads x 256 = 2560).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        block_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        lru_width=2560,
        act="silu",
        tie_embeddings=True,
        scan_layers=False,  # heterogeneous pattern → list layout
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="recurrentgemma-tiny",
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=256,
        lru_width=64,
        local_window=32,
        attn_chunk=16,
    )
