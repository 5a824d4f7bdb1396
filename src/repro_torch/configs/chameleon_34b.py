"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion, VQ image tokens. [arXiv:2405.09818]

The modality frontend is a STUB: image patches are VQ-quantized into the
shared 65536-token vocab upstream, so input_specs() feeds token ids directly.
Chameleon uses QK-norm for training stability.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
    )


def tiny() -> ModelConfig:
    return config().replace(
        name="chameleon-tiny",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        scan_layers=False,
        attn_chunk=64,
    )
