"""Model configuration: a copy of the reference ``ModelConfig``.

The dataclass is kept field for field, so a config of either package
compares equal through ``dataclasses.asdict``. An arch id outside
``ARCH_IDS`` raises, naming ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    local_window: int = 0  # 0 → global attention
    attn_chunk: int = 512  # flash block size
    # layer pattern, cycled: entries in {attn, mlstm, slstm, rglru}
    block_pattern: tuple = ("attn",)
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0
    # recurrent dims
    lru_width: int = 0
    conv_width: int = 4
    # misc
    act: str = "silu"
    rms_norm: bool = True
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-time policy knobs
    remat: str = "full"  # none | dots | full
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if attention cost doesn't grow quadratically without bound
        (pure-recurrent or bounded local window)."""
        kinds = set(self.block_pattern)
        if "attn" not in kinds:
            return True
        return self.local_window > 0

    def pattern_for_layers(self) -> tuple:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate total parameter count (embedding + blocks)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d  # embed (+ tied unembed)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        dense_mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        moe_mlp = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        for kind in self.pattern_for_layers():
            if kind == "attn":
                n += attn
                n += moe_mlp if self.is_moe else dense_mlp
            elif kind == "rglru":
                w = self.lru_width or d
                n += 2 * d * w + w * d + 3 * w * (w // max(self.n_heads, 1)) + self.conv_width * w
                n += dense_mlp
            elif kind == "mlstm":
                di = 2 * d
                n += d * 2 * di + 3 * di * di + 2 * di + di * d + self.conv_width * di
            elif kind == "slstm":
                dh = d
                n += 4 * d * dh + 4 * dh * (dh // max(self.n_heads, 1))
                n += 2 * d * int(d * 4 / 3)
        if self.is_encoder_decoder:
            enc = (attn + dense_mlp) * self.n_enc_layers
            cross = (4 * d * self.n_heads * hd) * self.n_layers
            n += enc + cross
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts instead of all)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_total = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        moe_active = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return full - moe_total + moe_active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The reference's four LM shape cells.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# The archs the port runs: all ten of the reference's, in its order.
ARCH_IDS = [
    "qwen3-moe-235b-a22b",
    "granite-moe-3b-a800m",
    "xlstm-125m",
    "whisper-tiny",
    "smollm-360m",
    "deepseek-coder-33b",
    "llama3-8b",
    "qwen2.5-3b",
    "chameleon-34b",
    "recurrentgemma-2b",
]


def _module_for(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not an arch of repro_torch; its archs "
            f"are {ARCH_IDS} (the reference's ten). See ROADMAP.md.")
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    return _module_for(arch_id).config()


def get_tiny_config(arch_id: str) -> ModelConfig:
    return _module_for(arch_id).tiny()


def cells(arch_id: str) -> list[tuple[str, str]]:
    """The (arch, shape) cells of an arch: every shape, ``long_500k`` only
    for a sub-quadratic arch (full attention at 500k is skipped, as the
    reference skips it)."""
    cfg = get_config(arch_id)
    return [(arch_id, shape.name) for shape in SHAPES.values()
            if shape.name != "long_500k" or cfg.sub_quadratic]


def all_cells() -> list[tuple[str, str]]:
    return [cell for arch in ARCH_IDS for cell in cells(arch)]
