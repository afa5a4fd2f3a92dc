"""The ten assigned architectures (exact public-literature configs).

Every entry cites its source.  Heterogeneous stacks are expressed as repeating
periods (see configs.base); the mapping is noted per arch.  ``reduced()``
returns the smoke-test variant of the same family (<=2 periods, d_model<=512,
<=4 experts) exercised on CPU in tests/. The port's copy of the reference's table, entry
for entry.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    ArchConfig,
    BlockSpec,
    EncoderConfig,
    MambaConfig,
    MoEConfig,
    RWKVConfig,
)

_D = BlockSpec  # shorthand


def _jamba_period() -> tuple[BlockSpec, ...]:
    """Jamba period of 8: 1 attention + 7 mamba (1:7), MoE every other layer.

    [arXiv:2403.19887] — attention layer sits at position 4 of each period;
    MoE replaces the dense MLP on every second layer (even positions).
    """
    blocks = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        mlp = "moe" if i % 2 == 0 else "dense"
        blocks.append(BlockSpec(mixer=mixer, mlp=mlp))
    return tuple(blocks)


JAMBA_1_5_LARGE = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="[arXiv:2403.19887] Jamba-1.5-Large: 94B active / 398B total",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    period=_jamba_period(),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    long_context="native",  # mamba layers O(1); attn layers use long_window
    long_window=8192,
)

GRANITE_8B = ArchConfig(
    name="granite-8b",
    family="dense",
    source="[arXiv:2405.04324] Granite Code 8B — llama arch, GQA kv=8",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    period=(_D(),),
    long_context="window",
)

PHI4_MINI = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="[arXiv:2412.08905] Phi-4-mini — RoPE SwiGLU GQA, 200k vocab",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    period=(_D(),),
    long_context="window",
)

LLAMA_32_VISION = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="[hf:meta-llama/Llama-3.2-11B-Vision] scaled per assignment: "
    "100L cross-attn image layers every 5th",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    period=(_D(mixer="cross"), _D(), _D(), _D(), _D()),
    encoder=EncoderConfig(n_frontend_tokens=576, d_frontend=1280, n_encoder_layers=0),
    long_context="window",
)

RWKV6_1_6B = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="[arXiv:2404.05892] RWKV-6 Finch 1.6B — data-dependent decay",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # 2048 / head_dim 64 (attention-free; heads = wkv heads)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    period=(_D(mixer="rwkv", mlp="rwkv_ffn"),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    long_context="native",
)

SMOLLM_360M = ArchConfig(
    name="smollm-360m",
    family="dense",
    source="[hf:HuggingFaceTB/SmolLM-360M] llama-arch small, GQA kv=5",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    period=(_D(),),
    tie_embeddings=True,
    long_context="window",
)

GRANITE_MOE_3B = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="[hf:ibm-granite/granite-3.0-3b-a800m] 40 experts top-8",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    period=(_D(mlp="moe"),),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    long_context="window",
)

QWEN3_MOE_235B = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="[hf:Qwen/Qwen3-235B-A22B] 128 experts top-8, GQA kv=4",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    period=(_D(mlp="moe"), _D(mlp="moe")),  # period 2 keeps scan len 47
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    long_context="window",
)

WHISPER_SMALL = ArchConfig(
    name="whisper-small",
    family="audio",
    source="[arXiv:2212.04356] Whisper small — enc-dec, conv frontend stubbed",
    n_layers=24,  # 12 decoder layers x (self-attn block + cross-attn block)
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    period=(_D(mixer="attn_nope", mlp="none"), _D(mixer="cross", mlp="dense")),
    encoder=EncoderConfig(n_frontend_tokens=1500, d_frontend=768, n_encoder_layers=12),
    long_context="skip",  # enc-dec audio: 500k-token decoder cache is meaningless
)

YI_9B = ArchConfig(
    name="yi-9b",
    family="dense",
    source="[arXiv:2403.04652] Yi-9B — llama arch GQA kv=4",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    period=(_D(),),
    long_context="window",
)

ARCHS: dict[str, ArchConfig] = {
    a.name: a
    for a in [
        JAMBA_1_5_LARGE,
        GRANITE_8B,
        PHI4_MINI,
        LLAMA_32_VISION,
        RWKV6_1_6B,
        SMOLLM_360M,
        GRANITE_MOE_3B,
        QWEN3_MOE_235B,
        WHISPER_SMALL,
        YI_9B,
    ]
}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/period pattern, tiny dims.

    <= 2 periods, d_model <= 512, <= 4 experts, small vocab.
    """
    n_layers = len(cfg.period) * min(2, cfg.n_periods)
    overrides: dict = dict(
        n_layers=n_layers,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab=512,
        param_dtype="float32",
    )
    if cfg.name == "smollm-360m":  # odd-head family: keep 3:1 GQA flavor
        overrides.update(n_heads=3, n_kv_heads=1)
    if cfg.name == "rwkv6-1.6b":
        overrides.update(n_heads=4, n_kv_heads=4)
        overrides["rwkv"] = RWKVConfig(head_dim=64, decay_lora=16)
    if cfg.moe is not None:
        overrides["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k), d_ff_expert=128
        )
    if cfg.mamba is not None:
        overrides["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
    if cfg.encoder is not None:
        overrides["encoder"] = EncoderConfig(
            n_frontend_tokens=16,
            d_frontend=64,
            n_encoder_layers=min(2, cfg.encoder.n_encoder_layers),
        )
    return cfg.scaled(**overrides)
