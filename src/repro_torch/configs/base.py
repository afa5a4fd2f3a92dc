"""Architecture + run configuration dataclasses.

Every assigned architecture is expressed as an ``ArchConfig``.  Heterogeneous
stacks (Jamba's 1:7 attn:mamba interleave, Llama-Vision's every-5th cross-attn
layer) are expressed as a repeating *period*: a short list of block specs that
is scanned ``n_layers / len(period)`` times.  This keeps the compiled HLO
size O(period), not O(n_layers) — essential for 100-layer dry-runs. (The
port's copy: the same dataclasses and values, with ``ArchConfig.dtype`` a
torch dtype. Its model walks the periods with a Python loop.)

Block kinds:
  * ``attn``        — GQA self-attention (RoPE), optional sliding window
  * ``attn_nope``   — bidirectional/sinusoidal attention (whisper encoder)
  * ``mamba``       — selective SSM
  * ``rwkv``        — RWKV-6 time-mix
  * ``cross``       — cross-attention to frontend embeddings (VLM / enc-dec)
  * MLP flavor per block: ``dense`` (SwiGLU) or ``moe``
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"  # attn | attn_nope | mamba | rwkv | cross
    mlp: str = "dense"  # dense | moe | none
    sliding_window: int | None = None  # tokens; None = full attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int | None = None  # defaults to ArchConfig.d_ff
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay LoRA


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Frontend/encoder for enc-dec (whisper) and VLM (llama-vision) archs.

    Per the assignment carve-out, the modality frontend (conv/mel, ViT) is a
    stub: ``input_specs`` provides precomputed frame/patch embeddings of shape
    ``(batch, n_frontend_tokens, d_frontend)``; a learned projector maps them
    to d_model.  For whisper the *transformer encoder* itself IS implemented
    (it is backbone, not frontend); for VLM the cross-attention consumes the
    projected patch embeddings directly.
    """

    n_frontend_tokens: int = 1500
    d_frontend: int = 768
    n_encoder_layers: int = 0  # transformer encoder layers (whisper: 12)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    source: str  # citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    period: Sequence[BlockSpec] = (BlockSpec(),)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    encoder: EncoderConfig | None = None
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    # tensor-parallel axis for attention projections: "heads" (default) or
    # "head_dim" — the latter keeps TP efficient when n_heads doesn't divide
    # the model-axis size (smollm 15H/phi4 24H/whisper 12H on a 16-wide axis)
    attn_tp: str = "heads"
    # long-context decode policy: "native" (SSM/linear — no cache growth),
    # "window" (sliding-window KV cache), or "skip" (full attention only)
    long_context: str = "window"
    long_window: int = 8192

    def __post_init__(self):
        if self.n_layers % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}"
            )
        for i, spec in enumerate(self.period):
            # rwkv_ffn carries token-shift state in the block's RWKVState;
            # every other mixer caches a KVCache/MambaState at serving time,
            # which has no ffn_x_prev slot to thread it through — reject the
            # combination up front instead of an AttributeError mid-decode
            if spec.mlp == "rwkv_ffn" and spec.mixer != "rwkv":
                raise ValueError(
                    f"{self.name}: period[{i}] combines mlp='rwkv_ffn' with "
                    f"mixer='{spec.mixer}' — the rwkv channel-mix FFN needs "
                    "the RWKVState serving cache of the 'rwkv' mixer (other "
                    "mixers' caches carry no ffn token-shift slot); use "
                    "mlp='dense'/'moe' here or mixer='rwkv'"
                )

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        """``param_dtype`` as a torch dtype (``"bfloat16"`` -> ``torch.bfloat16``)."""
        dtype = getattr(torch, self.param_dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"{self.name}: unknown param_dtype {self.param_dtype!r}")
        return dtype

    def scaled(self, **overrides) -> "ArchConfig":
        """A reduced variant of the same family (for smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run-level configuration: protocol + optimizer + schedule."""

    arch: str = "smollm-360m"
    shape: str = "train_4k"
    # LAD protocol
    protocol: str = "lad"  # lad | plain | none (none = honest mean all-reduce)
    # Protocol realization:
    #   "protomath" — per-parameter robust exchange inside the backward pass
    #                 (custom_vjp rules of core.protomath; the GSPMD-sharded
    #                 production path: all-to-all / all-gather servers)
    #   "engine"    — whole-model protocol round via core.byzantine: per-subset
    #                 gradients are computed explicitly (vmap over the device
    #                 blocks of the batch), flattened, and pushed through the
    #                 same assignment -> eq.-(5) encode -> compress -> attack ->
    #                 robust-aggregate pipeline as the paper's linear-regression
    #                 runs (Algorithm 1/2 verbatim, incl. the randomized cyclic
    #                 task matrix that protomath approximates with data rolls)
    protocol_impl: str = "protomath"
    # logical LAD device count for the engine path (None: the mesh's data
    # size); the global batch's leading dim must be divisible by it
    n_subsets: int | None = None
    # Device sharding of the engine path's per-subset gradient fan-out
    # ("none" | "pmap" | "shard_map" — the grid engine's substrate axis):
    # the subset axis is padded to a multiple of the engine device count by
    # replicating the last subset's batch block (launch.mesh contract), each
    # device computes its subsets' gradients, and the full round body
    # (assignment -> eq.-(5) encode -> compress -> attack -> aggregate) runs
    # replicated on the all-gathered (N, P) stack.  Engine-path only: the
    # protomath realization shards via GSPMD instead and rejects shard!=none.
    shard: str = "none"
    d: int = 2  # computational load (subsets per device)
    aggregator: str = "cwtm"
    trim_frac: float = 0.125
    n_byz: int = 0
    attack: str = "sign_flip"
    server: str = "sharded"  # sharded (all_to_all) | gather (paper baseline)
    compression: str = "none"  # none | rand_sparse | rand_sparse_shared | quant
    q_hat_frac: float = 0.3
    quant_levels: int = 16
    # optimizer
    # gradient accumulation: the local (d-redundant) batch is split into this
    # many microbatches; the LAD robust exchange runs per microbatch (the
    # aggregation granularity becomes the micro-round — see DESIGN.md) and the
    # shard-sized robust gradients are accumulated in fp32.
    microbatches: int = 1
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.01
    momentum_dtype: str = "bfloat16"
    steps: int = 100
    seed: int = 0
    remat: bool = True
