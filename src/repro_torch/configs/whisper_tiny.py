"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865; enc-dec
with conv frontend STUB (the frames are precomputed (B, 1500, 384) frame
embeddings). [arXiv:2212.04356]

Whisper uses LayerNorm + GELU + absolute (sinusoidal) positions, no RoPE.
The encoder's self-attention is bidirectional over 1500 frames and the
decoder's causal: both run the flash kernel; cross-attention and decode
attention are plain PyTorch, as the reference has no kernel for them.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        is_encoder_decoder=True,
        n_enc_layers=4,
        enc_seq=1500,
        act="gelu",
        rms_norm=False,
        use_rope=False,
        tie_embeddings=True,
        scan_layers=False,
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="whisper-tiny-tiny",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        enc_seq=32,
        attn_chunk=64,
    )
