"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks (alternating), no separate MLP (d_ff=0: xLSTM blocks carry their own
up/down projections). [arXiv:2405.04517]

Pure-recurrent: no attention block, so neither flash kernel runs on its
path.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=("mlstm", "slstm"),
        use_rope=False,
        tie_embeddings=True,
        scan_layers=False,  # heterogeneous pattern → list layout
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="xlstm-tiny",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        vocab_size=256,
    )
