"""Com-LAD wire compression (Section V, Definition 2).

  * ``identity``;
  * random sparsification (``random_sparsification``), per device
    (``rand_sparse``) or with one mask shared by every device
    (``rand_sparse_shared``, ``rand_k_shared_mask``): keeps ``q_hat``
    coordinates and scales them by ``Q / q_hat``. The kept coordinates come
    in as indices (``keep_idx``, one row per device) drawn outside the
    round;
  * ``quant``: QSGD stochastic quantization per chunk (the quantize
    kernel), its rounding draws ``quant_u`` (one (Q,) row of uniforms per
    device) drawn outside the round;
  * ``top_k``: the biased top-k sparsification of the ablations, no draws.

The fleet's payload codec (``pack_payload`` / ``unpack_payload``, numpy
only) ships a block of compressed rows in its physically small form:
bit-packed QSGD levels with per-chunk scales, or index and value records for
the sparse compressors, byte for byte the reference's.

``CompressionSpec`` keeps the reference's one spelling of a condition:
``"identity" | "randk:8" | "randk:0.3" | "randk_shared:8" | "quant:4" |
"topk:8"``.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from functools import partial
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops

Compressor = Callable[..., torch.Tensor]

__all__ = [
    "CompressionSpec",
    "spec_from",
    "identity",
    "random_sparsification",
    "rand_k_shared_mask",
    "stochastic_quantization",
    "top_k",
    "make_compressor",
    "compress_rows",
    "sample_keep_idx",
    "sample_quant_u",
    "delta_of",
    "wire_bits",
    "SPARSE",
    "PayloadError",
    "quant_level_bits",
    "packed_nbytes",
    "pack_payload",
    "unpack_payload",
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


def identity(rows: torch.Tensor, draws: torch.Tensor | None = None) -> torch.Tensor:
    return rows


def _permutations(rows: int, q: int, generator: torch.Generator) -> torch.Tensor:
    """``rows`` random permutations of ``[0, q)`` (the argsort of uniform
    draws) from ``generator``, on its device."""
    return torch.rand((rows, q), generator=generator, device=generator.device).argsort(dim=-1)


def rand_k_shared_mask(perm: torch.Tensor | None, q: int, q_hat: int, *,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """The 0/1 float32 sparsity mask ``(..., Q)`` with ones at the first
    ``q_hat`` entries of ``perm`` (``(..., >= q_hat)``: a permutation of Q,
    or the kept indices themselves); with no ``perm``, one permutation drawn
    from ``generator``. The round-shared mask of ``rand_sparse_shared``
    comes from the round's one draw."""
    if perm is None:
        perm = _permutations(1, q, generator)[0]
    idx = perm[..., :q_hat].long()
    return torch.zeros(idx.shape[:-1] + (q,), dtype=torch.float32, device=idx.device).scatter_(-1, idx, 1.0)


def random_sparsification(g: torch.Tensor, perm: torch.Tensor | None, q_hat: int, *,
                          generator: torch.Generator | None = None) -> torch.Tensor:
    """Keep ``q_hat`` coordinates of each row of ``g`` (``(..., Q)``), the
    first ``q_hat`` entries of the row's ``perm`` (see
    ``rand_k_shared_mask``), scaled by ``Q / q_hat``: unbiased, delta =
    Q / q_hat - 1. With no ``perm``, one permutation a row drawn from
    ``generator``."""
    q = g.shape[-1]
    if perm is None:
        perm = _permutations(math.prod(g.shape[:-1]), q, generator).reshape(g.shape)
    return g * rand_k_shared_mask(perm, q, q_hat).to(g.dtype) * (q / q_hat)


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


def make_compressor(spec: CompressionSpec, q: int) -> Compressor:
    """The per-row map ``(rows (..., R, Q), draws) -> (..., R, Q)`` of
    ``spec`` at width ``q``. ``draws`` are the rows' kept indices (the
    sparse compressors: each row its own, or the one shared row repeated),
    their rounding uniforms (``quant``), or ``None``."""
    if spec.name in ("none", "identity"):
        return identity
    if spec.name in SPARSE:
        return partial(random_sparsification, q_hat=spec.kept(q))
    if spec.name == "quant":
        def quantize(rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
            # QSGD works row by row: the lanes fold into rows
            return stochastic_quantization(rows.reshape(-1, q), u.reshape(-1, q), spec.levels,
                                           spec.chunk).reshape(rows.shape)
        return quantize
    if spec.name == "top_k":
        return lambda rows, draws=None: top_k(rows, spec.kept(q))
    raise KeyError(f"unknown compressor {spec.name!r}")


def compress_rows(spec: CompressionSpec, rows: torch.Tensor,
                  keep_idx: torch.Tensor | None = None,
                  quant_u: torch.Tensor | None = None) -> torch.Tensor:
    """Apply ``spec`` (``make_compressor``) to the (..., R, Q) coded rows of
    a round (leading axes are lanes); ``keep_idx`` holds each row's kept
    coordinates for the sparse compressors (the same row repeated for
    ``rand_sparse_shared``), ``quant_u`` each row's rounding draws for
    ``quant``."""
    q = rows.shape[-1]
    draws = None
    if spec.name in SPARSE:
        if keep_idx is None or keep_idx.shape != rows.shape[:-1] + (spec.kept(q),):
            raise ValueError(f"{spec.name} needs keep_idx of shape (..., R, q_hat)")
        draws = keep_idx
    elif spec.name == "quant":
        if quant_u is None or quant_u.shape != rows.shape:
            raise ValueError("quant needs quant_u of the rows' shape (..., R, Q)")
        draws = quant_u
    return make_compressor(spec, q)(rows, draws)


def sample_keep_idx(spec: CompressionSpec, n: int, q: int,
                    generator: torch.Generator) -> torch.Tensor | None:
    """Each device's kept coordinates for a round, drawn from ``generator``:
    the first ``q_hat`` entries of a random permutation of Q (the argsort of
    uniform draws), one per device, or one for all devices with
    ``rand_sparse_shared``."""
    if spec.name not in SPARSE:
        return None
    rows = 1 if spec.name == "rand_sparse_shared" else n
    return _permutations(rows, q, generator)[:, : spec.kept(q)].expand(n, -1).contiguous()


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


# ---------------------------------------------------------------------------
# The payload codec (numpy only: it runs on the fleet's socket path). A
# packed payload describes itself:
#
#     _CHDR(rows, q)  +  codec body
#
# quant body, per row: n_chunks x f32 chunk scales, then q coordinates
#     bit-packed at quant_level_bits(levels) bits each (little bit order),
#     each stored as the unsigned level u = yq + levels in [0, 2*levels].
# sparse body (randk / randk_shared / topk), per row: u16 nonzero count,
#     count x u32 strictly increasing indices, count x f32 values.
# identity body: raw row-major f32 (the fleet ships identity rows as plain
#     ROWS frames; the codec stays total for the tests).
#
# Lossless: the packed form is derived from the dense compressed rows (the
# dequantized output), and unpacking repeats the dequantization's float32
# op order, so unpack(pack(rows)) == rows bit for bit (up to +0.0 against
# -0.0 at dropped sparse coordinates).
# ---------------------------------------------------------------------------

_CHDR = struct.Struct("!HI")  # (rows, q)
_CNT = struct.Struct("!H")  # sparse per-row nonzero count


class PayloadError(ValueError):
    """A structurally invalid compressed payload. ``reason`` is one of the
    fleet's wire-fault buckets: ``"wrong_shape"`` for a header that
    disagrees with the agreed geometry, ``"bad_payload"`` for everything
    else (truncation, out-of-range levels, unsorted or out-of-bounds sparse
    indices)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


def quant_level_bits(levels: int) -> int:
    """Bits a coordinate for the unsigned level u in [0, 2*levels]."""
    return max(1, math.ceil(math.log2(2 * levels + 1)))


def _quant_geometry(spec: CompressionSpec, q: int) -> tuple[int, int, int]:
    """(n_chunks, bits a coordinate, packed bytes a row) of the quant codec."""
    n_chunks = -(-q // spec.chunk)
    b = quant_level_bits(spec.levels)
    return n_chunks, b, n_chunks * 4 + -(-(q * b) // 8)


def packed_nbytes(spec: CompressionSpec, shape: tuple[int, int]) -> int:
    """Payload bytes of an ``(R, Q)`` block: exact for identity and quant,
    the most for the sparse compressors (every kept coordinate nonzero)."""
    rows, q = shape
    if spec.name in ("none", "identity"):
        return _CHDR.size + rows * q * 4
    if spec.name == "quant":
        return _CHDR.size + rows * _quant_geometry(spec, q)[2]
    if spec.name in ("rand_sparse", "rand_sparse_shared", "top_k"):
        return _CHDR.size + rows * (_CNT.size + spec.kept(q) * 8)
    raise KeyError(spec.name)


def _pack_quant_row(spec: CompressionSpec, row: np.ndarray) -> bytes:
    q = row.shape[0]
    gc = np.pad(row, (0, (-q) % spec.chunk)).reshape(-1, spec.chunk)
    # the argmax coordinate dequantizes to +/-scale exactly, so the chunk
    # scale is read back from the dense output without a side channel
    scale = np.max(np.abs(gc), axis=1, keepdims=True).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    yq = np.rint(gc / safe * np.float32(spec.levels))  # integer recovery, error << 0.5
    u = (yq.reshape(-1)[:q] + spec.levels).astype(np.uint32)
    b = quant_level_bits(spec.levels)
    bits = ((u[:, None] >> np.arange(b, dtype=np.uint32)) & 1).astype(np.uint8)
    return scale.astype("<f4").tobytes() + np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _unpack_quant_row(spec: CompressionSpec, buf: memoryview, q: int) -> np.ndarray:
    n_chunks, b, _ = _quant_geometry(spec, q)
    scale = np.frombuffer(buf[: n_chunks * 4], dtype="<f4").reshape(-1, 1)
    if not np.all(np.isfinite(scale)) or np.any(scale < 0):
        raise PayloadError("bad_payload", "non-finite or negative chunk scale")
    raw = np.unpackbits(np.frombuffer(buf[n_chunks * 4:], dtype=np.uint8), count=q * b, bitorder="little")
    u = (raw.reshape(q, b).astype(np.uint32) << np.arange(b, dtype=np.uint32)).sum(axis=1)
    if np.any(u > 2 * spec.levels):
        raise PayloadError("bad_payload", "quant level out of range")
    # the dequantization's float32 op order: yq / levels * safe, 0 where scale == 0
    yq = np.pad(u.astype(np.float32) - np.float32(spec.levels), (0, (-q) % spec.chunk)).reshape(-1, spec.chunk)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    out = np.where(scale > 0, yq / np.float32(spec.levels) * safe, np.float32(0.0))
    return out.reshape(-1)[:q].astype(np.float32)


def pack_payload(spec: CompressionSpec, rows: np.ndarray) -> bytes:
    """The wire form of a dense ``(R, Q)`` float32 block of compressed rows
    (layout above)."""
    rows = np.asarray(rows, dtype=np.float32)
    if rows.ndim != 2:
        raise ValueError(f"expected a (rows, q) block, got shape {rows.shape}")
    r, q = rows.shape
    if r > 0xFFFF:
        raise ValueError(f"too many rows to pack: {r}")
    head = _CHDR.pack(r, q)
    if spec.name in ("none", "identity"):
        return head + rows.astype("<f4").tobytes()
    if spec.name == "quant":
        return head + b"".join(_pack_quant_row(spec, rows[i]) for i in range(r))
    if spec.name in ("rand_sparse", "rand_sparse_shared", "top_k"):
        parts = [head]
        for i in range(r):
            idx = np.flatnonzero(rows[i]).astype(np.uint32)
            if idx.size > 0xFFFF:
                raise ValueError(f"sparse row too dense to pack: {idx.size} nonzeros")
            parts += [_CNT.pack(idx.size), idx.astype(">u4").tobytes(), rows[i, idx].astype(">f4").tobytes()]
        return b"".join(parts)
    raise KeyError(spec.name)


def unpack_payload(spec: CompressionSpec, buf: bytes, expect_shape: tuple[int, int]) -> np.ndarray:
    """``pack_payload``'s output back to the dense ``(R, Q)`` float32 block.
    Raises :class:`PayloadError` on any structural fault, so the fleet tallies
    a malformed payload as an erasure."""
    mv = memoryview(buf)
    if len(mv) < _CHDR.size:
        raise PayloadError("bad_payload", "truncated header")
    r, q = _CHDR.unpack_from(mv, 0)
    if (r, q) != tuple(expect_shape):
        raise PayloadError("wrong_shape", f"declared {(r, q)} != agreed {tuple(expect_shape)}")
    body = mv[_CHDR.size:]
    if spec.name in ("none", "identity"):
        if len(body) != r * q * 4:
            raise PayloadError("bad_payload", "identity body size mismatch")
        return np.frombuffer(body, dtype="<f4").reshape(r, q).astype(np.float32)
    if spec.name == "quant":
        per_row = _quant_geometry(spec, q)[2]
        if len(body) != r * per_row:
            raise PayloadError("bad_payload", "quant body size mismatch")
        out = np.empty((r, q), dtype=np.float32)
        for i in range(r):
            out[i] = _unpack_quant_row(spec, body[i * per_row:(i + 1) * per_row], q)
        return out
    if spec.name in ("rand_sparse", "rand_sparse_shared", "top_k"):
        k_max = spec.kept(q)
        out = np.zeros((r, q), dtype=np.float32)
        off = 0
        for i in range(r):
            if len(body) - off < _CNT.size:
                raise PayloadError("bad_payload", "truncated sparse row header")
            (count,) = _CNT.unpack_from(body, off)
            off += _CNT.size
            if count > k_max:
                raise PayloadError("bad_payload", f"sparse count {count} exceeds budget {k_max}")
            if len(body) - off < count * 8:
                raise PayloadError("bad_payload", "truncated sparse row body")
            idx = np.frombuffer(body[off:off + count * 4], dtype=">u4")
            vals = np.frombuffer(body[off + count * 4:off + count * 8], dtype=">f4").astype(np.float32)
            off += count * 8
            if count and (idx[-1] >= q or np.any(np.diff(idx.astype(np.int64)) <= 0)):
                raise PayloadError("bad_payload", "sparse indices unsorted or out of range")
            out[i, idx.astype(np.int64)] = vals
        if off != len(body):
            raise PayloadError("bad_payload", "trailing bytes after sparse rows")
        return out
    raise KeyError(spec.name)
