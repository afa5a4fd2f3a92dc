"""Com-LAD wire compression (Section V, Definition 2).

  * ``identity``;
  * random sparsification, per device (``rand_sparse``) or with one mask
    shared by every device (``rand_sparse_shared``): keeps ``q_hat``
    coordinates and scales them by ``Q / q_hat``. The kept coordinates come
    in as indices (``keep_idx``, one row per device) drawn outside the
    round;
  * ``quant``: QSGD stochastic quantization per chunk (the quantize
    kernel), its rounding draws ``quant_u`` (one (Q,) row of uniforms per
    device) drawn outside the round;
  * ``top_k``: the biased top-k sparsification of the ablations, no draws.

The fleet's payload codec (bit-packed frames) comes with the fleet.

``CompressionSpec`` keeps the reference's one spelling of a condition:
``"identity" | "randk:8" | "randk:0.3" | "randk_shared:8" | "quant:4" |
"topk:8"``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops

__all__ = [
    "CompressionSpec",
    "spec_from",
    "identity",
    "rand_sparse",
    "stochastic_quantization",
    "top_k",
    "compress_rows",
    "sample_keep_idx",
    "sample_quant_u",
    "delta_of",
    "wire_bits",
    "SPARSE",
]

SPARSE = ("rand_sparse", "rand_sparse_shared")

_SHORT_TO_NAME = {
    "identity": "none",
    "none": "none",
    "randk": "rand_sparse",
    "rand_sparse": "rand_sparse",
    "randk_shared": "rand_sparse_shared",
    "rand_sparse_shared": "rand_sparse_shared",
    "topk": "top_k",
    "top_k": "top_k",
    "quant": "quant",
}
_NAME_TO_SHORT = {
    "none": "identity",
    "rand_sparse": "randk",
    "rand_sparse_shared": "randk_shared",
    "top_k": "topk",
    "quant": "quant",
}
_DEFAULT_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Config-level description of the wire compression. The sparse budget
    is a kept fraction (``q_hat_frac``) or, when ``q_hat > 0``, a kept
    count."""

    name: str = "none"  # none | rand_sparse | rand_sparse_shared | quant | top_k
    q_hat_frac: float = 0.3
    levels: int = 16
    chunk: int = 1024
    q_hat: int = 0

    def kept(self, q: int) -> int:
        """The sparsification count ``q_hat`` for vectors of length q."""
        if self.q_hat > 0:
            return min(int(self.q_hat), q)
        return max(1, int(self.q_hat_frac * q))

    @classmethod
    def parse(cls, text: str) -> "CompressionSpec":
        """``short[:param[:chunk]]``; ``parse(spec.canonical())`` round-trips."""
        if not isinstance(text, str) or not text:
            raise ValueError(f"compression spec must be a non-empty string, got {text!r}")
        parts = text.strip().split(":")
        short = parts[0]
        if short not in _SHORT_TO_NAME:
            raise ValueError(
                f"unknown compressor {short!r}; known: {sorted(set(_NAME_TO_SHORT.values()))}"
            )
        name = _SHORT_TO_NAME[short]
        if name == "none":
            if len(parts) != 1:
                raise ValueError(f"identity takes no parameters, got {text!r}")
            return cls(name="none")
        if name == "quant":
            if len(parts) not in (2, 3):
                raise ValueError(f"quant spec is quant:LEVELS[:CHUNK], got {text!r}")
            levels = int(parts[1])
            chunk = int(parts[2]) if len(parts) == 3 else _DEFAULT_CHUNK
            if levels < 1 or chunk < 1:
                raise ValueError(f"quant levels/chunk must be >= 1, got {text!r}")
            return cls(name="quant", levels=levels, chunk=chunk)
        if len(parts) != 2:
            raise ValueError(f"{short} spec is {short}:COUNT or {short}:FRAC, got {text!r}")
        if "." in parts[1]:
            frac = float(parts[1])
            if not (0.0 < frac <= 1.0):
                raise ValueError(f"kept fraction must be in (0, 1], got {text!r}")
            return cls(name=name, q_hat_frac=frac)
        k = int(parts[1])
        if k < 1:
            raise ValueError(f"kept count must be >= 1, got {text!r}")
        return cls(name=name, q_hat=k)

    def canonical(self) -> str:
        """The registry spelling of this spec."""
        short = _NAME_TO_SHORT[_SHORT_TO_NAME.get(self.name, self.name)]
        if self.name in ("none", "identity"):
            return "identity"
        if self.name == "quant":
            if self.chunk != _DEFAULT_CHUNK:
                return f"quant:{self.levels}:{self.chunk}"
            return f"quant:{self.levels}"
        if self.q_hat > 0:
            return f"{short}:{self.q_hat}"
        return f"{short}:{self.q_hat_frac:g}"


def spec_from(name: str, *, q_hat_frac: float = 0.3, levels: int = 16,
              chunk: int = 1024) -> CompressionSpec:
    """A spec from a registry spelling (anything with ``:``) or a bare name
    plus keyword fields, as ``Scenario`` rows give it."""
    if ":" in name:
        return CompressionSpec.parse(name)
    return CompressionSpec(name=name, q_hat_frac=q_hat_frac, levels=levels, chunk=chunk)


def identity(rows: torch.Tensor) -> torch.Tensor:
    return rows


def rand_sparse(rows: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
    """Keep the coordinates ``keep_idx[..., i, :]`` of row ``i``, scaled by
    ``Q / q_hat``. rows: (..., R, Q), keep_idx: (..., R, q_hat) -> (..., R, Q)."""
    q, q_hat = rows.shape[-1], keep_idx.shape[-1]
    mask = torch.zeros_like(rows).scatter_(-1, keep_idx.long(), 1.0)
    return rows * mask * (q / q_hat)


def stochastic_quantization(g: torch.Tensor, u: torch.Tensor, levels: int = 16,
                            chunk: int = 1024) -> torch.Tensor:
    """QSGD-style unbiased stochastic quantization with per-chunk scaling,
    rounding with the given uniforms ``u`` (same shape as ``g``).

    Each chunk of ``chunk`` coordinates along the last axis is scaled by its
    max-abs, mapped onto ``levels`` uniform levels in [-1, 1] and rounded up
    with probability equal to the remainder, hence unbiased. Returns the
    dequantized vectors (the wire format is ``ceil(log2(2 levels + 1))``
    bits a coordinate plus one fp32 scale a chunk, see ``wire_bits``)."""
    return kernel_ops.stochastic_quantize(g, u, levels, chunk)


def top_k(rows: torch.Tensor, q_hat: int) -> torch.Tensor:
    """Biased top-k sparsification [15] (ablation only; violates eq. 9):
    each row keeps its ``q_hat`` coordinates of largest magnitude. A stable
    descending sort breaks ties toward the lower index, as the reference's
    ``jax.lax.top_k`` does (``torch.topk`` promises no order)."""
    idx = torch.sort(rows.abs(), dim=-1, descending=True, stable=True).indices[..., :q_hat]
    mask = torch.zeros_like(rows).scatter_(-1, idx, 1.0)
    return rows * mask


def compress_rows(spec: CompressionSpec, rows: torch.Tensor,
                  keep_idx: torch.Tensor | None = None,
                  quant_u: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``spec`` to the (..., R, Q) coded rows of a round (leading
    axes are lanes); ``keep_idx`` holds each row's kept coordinates for the
    sparse compressors (the same row repeated for ``rand_sparse_shared``),
    ``quant_u`` each row's rounding draws for ``quant``."""
    q = rows.shape[-1]
    if spec.name in ("none", "identity"):
        return identity(rows)
    if spec.name in SPARSE:
        if keep_idx is None or keep_idx.shape != rows.shape[:-1] + (spec.kept(q),):
            raise ValueError(f"{spec.name} needs keep_idx of shape (..., R, q_hat)")
        return rand_sparse(rows, keep_idx)
    if spec.name == "quant":
        if quant_u is None or quant_u.shape != rows.shape:
            raise ValueError("quant needs quant_u of the rows' shape (..., R, Q)")
        # QSGD works row by row: the lanes fold into rows
        folded = stochastic_quantization(rows.reshape(-1, q), quant_u.reshape(-1, q), spec.levels, spec.chunk)
        return folded.reshape(rows.shape)
    if spec.name == "top_k":
        return top_k(rows, spec.kept(q))
    raise KeyError(f"unknown compressor {spec.name!r}")


def sample_keep_idx(spec: CompressionSpec, n: int, q: int,
                    generator: torch.Generator) -> torch.Tensor | None:
    """Each device's kept coordinates for a round, drawn from ``generator``:
    the first ``q_hat`` entries of a random permutation of Q (the argsort of
    uniform draws), one per device, or one for all devices with
    ``rand_sparse_shared``."""
    if spec.name not in SPARSE:
        return None
    rows = 1 if spec.name == "rand_sparse_shared" else n
    u = torch.rand((rows, q), generator=generator, device=generator.device)
    return u.argsort(dim=-1)[:, : spec.kept(q)].expand(n, -1).contiguous()


def sample_quant_u(spec: CompressionSpec, n: int, q: int,
                   generator: torch.Generator) -> torch.Tensor | None:
    """Each device's (Q,) rounding draws in [0, 1) for ``quant``, drawn
    from ``generator`` on its device."""
    if spec.name != "quant":
        return None
    return torch.rand((n, q), generator=generator, device=generator.device)


def delta_of(spec: CompressionSpec, q: int) -> float:
    """The eq.-(10) constant delta of each compressor."""
    if spec.name in ("none", "identity"):
        return 0.0
    if spec.name in SPARSE:
        return q / spec.kept(q) - 1.0
    if spec.name == "quant":
        # QSGD bound: delta <= min(Q / levels^2, sqrt(Q) / levels) for
        # full-vector scaling; with per-chunk scaling Q -> chunk
        c = min(spec.chunk, q)
        return min(c / spec.levels**2, (c**0.5) / spec.levels)
    if spec.name == "top_k":
        return 1.0 - spec.kept(q) / q  # contraction parameter (biased class)
    raise KeyError(spec.name)


def wire_bits(spec: CompressionSpec, q: int, value_bits: int = 32) -> float:
    """Payload bits needed to ship one compressed vector of length q."""
    idx_bits = max(1, math.ceil(math.log2(max(q, 2))))
    if spec.name in ("none", "identity"):
        return float(q * value_bits)
    if spec.name in ("rand_sparse", "top_k"):
        return float(spec.kept(q) * (value_bits + idx_bits))
    if spec.name == "rand_sparse_shared":
        return float(spec.kept(q) * value_bits)  # the mask comes from the shared round draw
    if spec.name == "quant":
        bits = math.ceil(math.log2(2 * spec.levels + 1))
        return float(q * bits + -(-q // spec.chunk) * 32)
    raise KeyError(spec.name)
