"""Protocol-aware parameter math: the LAD gradient exchange inside the
backward pass, over a ``torch.distributed`` data group.

The batch's leading axis is blocked over the ``N`` logical LAD devices,
``(N * b_local, ...)``, device ``n`` owning block ``n``. A data group of
``W`` ranks holds them rank-major: rank ``r`` runs the forward and backward
of blocks ``r * N/W .. (r + 1) * N/W - 1``. Every parameter-consuming op of
the models goes through the helpers here (``pmm``, ``plookup``, ``pscale``,
``pbias``, ``block_tap``); under ``protocol_context`` their backward:

  1. computes the *blocked* parameter cotangent ``dw_n`` with a leading
     device axis (``einsum("n<lhs>,n<out>->n<rhs>")``): one gradient a
     local block, never summed over blocks;
  2. applies the device-side transforms to the local rows: Com-LAD
     compression and the ``gaussian`` attack, their draws a function of the
     round's seed, the call site and the row's global index alone;
  3. exchanges and aggregates (``robust_combine``):

       * ``server="gather"``: the ranks ``all_gather`` their rows, and
         every rank aggregates all ``N``;
       * ``server="sharded"``: where the parameter's ``fsdp`` dim divides by
         ``W``, an ``all_to_all`` leaves each rank all ``N`` rows cut to its
         ``1/W`` of that dim; each rank aggregates its cut and the cuts are
         ``all_gather``-ed back. Other parameters take ``gather``;

     the Byzantine rows are the first ``n_byz`` blocks, the ``sign_flip``,
     ``alie`` and ``ipm`` attacks run on the exchanged rows through the
     attack kernel, and the rule (``mean``, ``median``, ``cwtm``, each
     optionally ``-nnm``) through the CWTM and Gram kernels. Every rule and
     attack is coordinate-wise, so both servers give the same bits (the
     NNM distances of a cut are summed over the ranks first).

A bf16 parameter's blocked cotangent is computed in bf16, as the
reference's, and cast to fp32 before compression and the attack (the
kernels take fp32); the reference attacks the bf16 rows, so its ALIE
statistics and flipped rows carry bf16 rounding that the port's do not.

The aggregate is the robust mean over the blocks of each block's
contribution to the global mean loss: ``1/N`` of the plain gradient under
the honest mean, as in the reference (ROADMAP C.8). Lookups aggregate by
the plain sum unless ``embedding_robust`` is set (the reference's default
protocol adaptation); across ranks that sum is an ``all_reduce``.

Tensor parallelism (``model_size > 1``, a ``model_group`` of that many
ranks): ``protocol_context`` takes ``cuts``, each stored leaf's cut (one
of ``"data"``, ``"model"`` or ``None`` a dim). A parameter-consuming op
takes the weight's compute view as the reference's ``_pin_w`` does: the
``data`` cut is all-gathered over the data group, the ``model`` cut kept.
A model-cut dim of ``w`` that appears in the output makes a
column-parallel product (its output stays cut; ``dx`` is all-reduced over
the model group in the backward); a contracted one a row-parallel product
(its output all-reduced, ``dx`` cut). ``plookup`` on a vocabulary-cut
table is a vocabulary-parallel lookup: rows outside this rank's range give
exact zeros, then the all-reduce; ``vocab_logsumexp`` is the log-sum-exp
over such a cut vocabulary. The blocked cotangent is then this rank's tp
slice of the leaf's, exchanged over the data group as above; the aggregate
comes back as the stored cut (the ``sharded`` server's cut is already the
``data`` cut, so its closing ``all_gather`` is skipped). Compression and
the ``gaussian`` attack read or draw across a whole row: for a model-cut
leaf the rows are all-gathered over the model group into the whole leaf's,
transformed as at ``model_size = 1``, and this rank's slice taken, so a
slice carries the bits ``model_size = 1`` gives its coordinates. The
``-nnm`` Gram and squared norms of a slice are summed over the model group
after the data cut's sum. Partial sums travel in fp32.

The other families' cuts: a model-cut dim that is in the input and the
output of a product (MoE's experts, ``necd,edf->necf``) is expert
parallelism, on an input already cut (``model_split``), with no
collective of its own; ``pmm(parts=)`` computes with this
rank's slice of each part of a leaf's cut dim (Mamba's x and z halves of
``in_proj``, stored cut contiguously), its cotangent moved back to the
stored cut before the exchange. ``pscale``, ``pbias`` and ``block_tap``
exchange a model-cut leaf (a row of one, ``index``; a transform of one,
``block_tap``'s ``fn``) on its cut, and cut a whole leaf to an input cut
over the model ranks, joining its blocked cotangent whole before the
exchange (RWKV's ``w0``, ``ln_scale``). ``model_split``, ``model_join``,
``model_grad_sum`` and ``model_logits_sum`` move activations between the
model ranks for the layers (MoE's dispatch and outputs, RWKV's
receptance, RoPE on a cut ``head_dim``, the whole k and v that q heads
cut alone read, Mamba's B and C, the logits of a cut ``head_dim``).

Each exchanged call site draws from generators seeded by ``(seed, site,
row, stream)``, ``seed`` the round's (``protocol_context``) and ``site``
the call's order in one forward; a loop over periods, encoder layers or
loss chunks shares its body's sites (``shared_sites``), as the reference's
scans trace their body once. The reference folds a process-global trace
counter into its keys instead (ROADMAP C.9), so its draws cannot be
replayed: the gaussian attack and the compressors are held to it
statistically. With no active context every helper is the plain op.

Serving carries no exchange: ``model_context`` activates the model axis
alone, forward only (under ``torch.no_grad()``), with no
``BlockedProtocol``. Its leaves hold no ``data`` cut (a serving rank
gathers that cut once, ``launch.serve``): ``pmm`` is column-, row- or
expert-parallel, ``plookup`` vocabulary-parallel, ``block_tap`` one copy,
the MoE routes the whole batch as one block (``data_join`` over the data
ranks where the batch is cut), and ``model_split``/``model_join``/
``model_grad_sum`` move the activations as in training.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import aggregators
from repro_torch.core import attacks as attack_lib
from repro_torch.core import compression as comp_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import sqdist_from_gram
from repro_torch.numerics import stable_mean0

__all__ = ["BlockedProtocol", "protocol_context", "model_context", "current_protocol", "shared_sites", "fold_seed",
           "sharded_dim", "robust_combine", "exchange_counts", "reset_exchange_counts", "lookup", "pmm", "plookup",
           "pscale", "pbias", "block_tap", "vocab_logsumexp", "tp_dim_of", "model_split", "model_join",
           "model_grad_sum", "model_logits_sum", "data_join", "data_part", "count_collective", "collective_counts",
           "reset_collective_counts"]

DATA_AXES_1POD: tuple[str, ...] = ("data",)
_COMPRESS, _NOISE = 0, 1  # draw streams of a site's rows


@dataclasses.dataclass(frozen=True)
class BlockedProtocol:
    """Static protocol parameters, the reference's fields."""

    n_devices: int = 16
    data_axes: tuple[str, ...] = DATA_AXES_1POD
    aggregator: str = "cwtm"  # mean | median | cwtm (optionally "-nnm")
    trim_frac: float = 0.125
    n_byz: int = 0
    attack: attack_lib.AttackSpec = dataclasses.field(default_factory=lambda: attack_lib.AttackSpec(name="sign_flip"))
    compression: comp_lib.CompressionSpec = dataclasses.field(default_factory=comp_lib.CompressionSpec)
    server: str = "sharded"  # sharded | gather
    honest_mean: bool = False  # protocol "none": the plain data-parallel mean
    model_size: int = 1  # ranks of the "model" axis, over which each leaf's tp dim is cut
    # Lookup gradients are sparse over the vocabulary, so a coordinate-wise
    # trimmed mean would trim their signal away: by default they aggregate
    # by the plain sum, as in the reference; True exchanges them too.
    embedding_robust: bool = False

    def __post_init__(self):
        if self.model_size < 1:
            raise ValueError(f"model_size={self.model_size}: expected at least 1")
        if self.server not in ("sharded", "gather"):
            raise ValueError(f"unknown server {self.server!r}: expected 'sharded' or 'gather'")


# --- context ----------------------------------------------------------------


@dataclasses.dataclass
class _Context:
    p: BlockedProtocol | None  # None: a forward-only model context (serving), no exchange
    seed: int
    group: Any  # a torch.distributed process group, or None: one rank, no collectives
    world: int
    rank: int
    model_group: Any = None  # the model ranks of this data rank, or None
    model_world: int = 1
    model_rank: int = 0
    cuts: dict = dataclasses.field(default_factory=dict)  # id(stored leaf) -> its cut
    site: int = 0
    batch_cut: bool = False  # the activations' batch is cut over the data group (serving)

    def cut_of(self, w: torch.Tensor) -> tuple | None:
        return self.cuts.get(id(w))


_ACTIVE: list[_Context] = []


def _world_rank(group: Any) -> tuple[int, int]:
    return (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))


@contextmanager
def protocol_context(p: BlockedProtocol, seed: int, group: Any = None, *, model_group: Any = None,
                     cuts: dict | None = None):
    """Activate the LAD exchange for every protomath call inside, under the
    round's ``seed``, over the data ``group`` (``None``: this process holds
    all ``N`` blocks and makes no collective call). ``model_group``: the
    ``p.model_size`` ranks a leaf's tp dim is cut over (``None`` at one);
    ``cuts``: ``{id(leaf): cut}`` for the stored leaves that are cut, a cut
    holding ``"data"``, ``"model"`` or ``None`` a dim (the leaves must
    outlive the context)."""
    world, rank = _world_rank(group)
    model_world, model_rank = _world_rank(model_group)
    if p.n_devices % world != 0:
        raise ValueError(f"N={p.n_devices} blocks do not split over {world} ranks")
    if model_world != p.model_size:
        raise ValueError(f"model_size={p.model_size}, but the model group holds {model_world} ranks")
    _ACTIVE.append(_Context(p, int(seed), group, world, rank, model_group, model_world, model_rank, dict(cuts or {})))
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextmanager
def model_context(model_group: Any = None, cuts: dict | None = None, *, group: Any = None, batch_cut: bool = False):
    """The model axis with no exchange, for a forward under
    ``torch.no_grad()`` (serving): every protomath op inside computes on
    the stored cuts ``cuts`` (``{id(leaf): cut}``, ``"model"`` or ``None`` a
    dim; no ``data`` cut) over ``model_group``. ``group``: the data ranks;
    ``batch_cut``: the activations hold this data rank's rows of the batch
    (``data_join`` gathers them). Raises where gradients are enabled: the
    ops' backward would exchange under a protocol this context lacks."""
    if torch.is_grad_enabled():
        raise RuntimeError("model_context is forward only: enter it under torch.no_grad()")
    if any("data" in cut for cut in (cuts or {}).values()):
        raise ValueError("a model context holds no data cut: gather it first")
    world, rank = _world_rank(group)
    model_world, model_rank = _world_rank(model_group)
    _ACTIVE.append(_Context(None, 0, group, world, rank, model_group, model_world, model_rank, dict(cuts or {}),
                            batch_cut=batch_cut and world > 1))
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_protocol() -> _Context | None:
    return _ACTIVE[-1] if _ACTIVE else None


class shared_sites:
    """Give every pass of a loop body the same call sites: each ``with``
    rewinds the site counter to where it stood when this was made, and the
    counter ends past the longest pass. A no-op outside a context."""

    def __init__(self):
        ctx = current_protocol()
        self.start = self.end = None if ctx is None else ctx.site

    def __enter__(self):
        ctx = current_protocol()
        if ctx is not None:
            ctx.site = self.start
        return self

    def __exit__(self, *exc):
        ctx = current_protocol()
        if ctx is not None:
            self.end = ctx.site = max(self.end, ctx.site)
        return False


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from ``seed`` and ``parts``: splitmix64 of
    the seed, each part xor-ed in and mixed again."""
    h = _splitmix64(seed & _MASK64)
    for part in parts:
        h = _splitmix64(h ^ (part & _MASK64))
    return h >> 1


@dataclasses.dataclass(frozen=True)
class _Site:
    """One exchanged call: the protocol, the site's seed and the group."""

    p: BlockedProtocol
    seed: int
    group: Any
    world: int
    rank: int
    model_group: Any = None
    model_world: int = 1
    model_rank: int = 0

    @property
    def n_local(self) -> int:
        return self.p.n_devices // self.world

    def generator(self, row: int, stream: int, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(fold_seed(self.seed, row, stream))


def _site_of(ctx: _Context, seed: int) -> _Site:
    return _Site(ctx.p, seed, ctx.group, ctx.world, ctx.rank, ctx.model_group, ctx.model_world, ctx.model_rank)


def _take_site() -> _Site:
    ctx = _ACTIVE[-1]
    site = _site_of(ctx, fold_seed(ctx.seed, ctx.site))
    ctx.site += 1
    return site


# --- aggregation over the device axis -----------------------------------------


def _trim_count(p: BlockedProtocol) -> int:
    f = int(p.trim_frac * p.n_devices)
    return min(f, (p.n_devices - 1) // 2)


def _apply_rule(p: BlockedProtocol, flat: torch.Tensor, gram_groups: tuple = ()) -> torch.Tensor:
    """(N, Q) fp32 -> (Q,). NNM's distances come from the Gram kernel
    (summed over each of ``gram_groups`` in turn when the columns are a
    cut), its neighbours by a stable sort, its mix inside the CWTM kernel."""
    name, n = p.aggregator, flat.shape[0]
    table = None
    if name.endswith("-nnm"):
        name = name[: -len("-nnm")]
        gram, sq = kernel_ops.gram(flat)
        for g in gram_groups:
            dist.all_reduce(gram, group=g)
            dist.all_reduce(sq, group=g)
        table = aggregators.nnm_neighbours(sqdist_from_gram(gram, sq), p.n_byz)
    if name == "mean":
        return stable_mean0(flat) if table is None else kernel_ops.cwtm(flat, 0, table)
    if name == "median":
        return kernel_ops.cwtm(flat, (n - 1) // 2, table)
    if name == "cwtm":
        return kernel_ops.cwtm(flat, _trim_count(p), table)
    raise KeyError(f"blocked protocol supports mean/median/cwtm[-nnm], got {p.aggregator!r}")


def _device_rows(site: _Site, rows: torch.Tensor) -> torch.Tensor:
    """Compression, then the ``gaussian`` attack, of this rank's (n_local,
    Q) fp32 rows of whole leaves; row ``i`` is global block ``rank *
    n_local + i`` and draws from its own generators."""
    p, (n_local, q), dev = site.p, rows.shape, rows.device
    first = site.rank * n_local
    spec = p.compression
    ids = range(first, first + n_local)

    def uniforms(row: int) -> torch.Tensor:
        return torch.rand((q,), generator=site.generator(row, _COMPRESS, dev), device=dev)

    if spec.name == "rand_sparse_shared":  # one mask for every row, drawn under a row id no block has
        keep = uniforms(p.n_devices).argsort()[: spec.kept(q)].expand(n_local, -1)
        rows = comp_lib.compress_rows(spec, rows, keep_idx=keep)
    elif spec.name == "rand_sparse":
        rows = comp_lib.compress_rows(spec, rows, keep_idx=torch.stack([uniforms(r).argsort()[: spec.kept(q)]
                                                                        for r in ids]))
    elif spec.name == "quant":
        rows = comp_lib.compress_rows(spec, rows, quant_u=torch.stack([uniforms(r) for r in ids]))
    elif spec.name not in ("none", "identity"):
        rows = comp_lib.compress_rows(spec, rows)
    if p.n_byz > 0 and p.attack.name == "gaussian":
        rows = rows.clone()
        for i in range(min(n_local, max(p.n_byz - first, 0))):
            noise = torch.randn((q,), generator=site.generator(first + i, _NOISE, dev), device=dev)
            rows[i] = p.attack.std * noise
    return rows


def _device_side(site: _Site, rows: torch.Tensor, shape: tuple = (), tp_dim: int | None = None) -> torch.Tensor:
    """``_device_rows`` of this rank's (n_local, prod(shape)) rows, its view
    ``shape`` of a leaf cut over the model ranks on ``tp_dim`` (or whole):
    a cut leaf's rows are all-gathered over the model group into the whole
    leaf's, transformed, and this rank's slice taken."""
    p = site.p
    if p.compression.name in ("none", "identity") and not (p.n_byz > 0 and p.attack.name == "gaussian"):
        return rows
    if tp_dim is None:
        return _device_rows(site, rows)
    n_local, m = rows.shape[0], site.model_world
    parts = _all_gather(rows.reshape((n_local,) + shape), site.model_group, m).reshape((m, n_local) + shape)
    whole = torch.cat(parts.unbind(0), dim=1 + tp_dim)
    done = _device_rows(site, whole.reshape(n_local, -1)).reshape(whole.shape)
    cut = shape[tp_dim]
    return done.narrow(1 + tp_dim, site.model_rank * cut, cut).reshape(n_local, -1).contiguous()


def _server_side(p: BlockedProtocol, flat: torch.Tensor) -> torch.Tensor:
    """The attacks that read all N rows (or are coordinate-wise) on the
    exchanged (N, Q') rows: Byzantine rows are the first ``n_byz``."""
    if p.n_byz == 0 or p.attack.name in ("none", "gaussian"):
        return flat
    mask = (torch.arange(flat.shape[0], device=flat.device) < p.n_byz).to(torch.float32)
    return attack_lib.make_attack(p.attack)(flat, mask)


def sharded_dim(w_spec: tuple | None, shape, world: int) -> int | None:
    """The dim of a parameter that the sharded server cuts over ``world``
    ranks: its ``fsdp`` dim where that divides by ``world``, else None (the
    parameter takes the gather server)."""
    if not w_spec or "fsdp" not in w_spec:
        return None
    dim = w_spec.index("fsdp")
    return dim if dim < len(shape) and shape[dim] % world == 0 else None


def _all_gather(x: torch.Tensor, group: Any, world: int) -> torch.Tensor:
    """(k, ...) on every rank -> (world * k, ...), rank-major."""
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    # all_gather_single where this PyTorch has it (all_gather_into_tensor, its older name, warns there)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, x.contiguous(), group=group)
    return out


def robust_combine(p: BlockedProtocol, dw_local: torch.Tensor, w_spec: tuple | None = None, *, seed: int = 0,
                   group: Any = None, model_group: Any = None, cut: tuple | None = None) -> torch.Tensor:
    """The server: this rank's blocked cotangent ``(N/W, *w)`` -> the
    aggregate in fp32, the same on every rank of ``group``. ``cut``: how
    the stored leaf is cut (``None``: whole); ``w`` is then its compute
    view (the ``data`` cut whole, the ``model`` cut this rank's slice over
    ``model_group``) and the aggregate comes back as the stored cut."""
    return _combine(_Site(p, seed, group, *_world_rank(group), model_group, *_world_rank(model_group)), dw_local,
                    w_spec, cut)


# exchanges in this process, by server: calls and the parameters they aggregated
_EXCHANGES = {"sharded_calls": 0, "gather_calls": 0, "elements": 0}


def exchange_counts() -> dict[str, int]:
    """A copy of the exchange counts: ``sharded_calls``, ``gather_calls``
    and ``elements``, the parameters aggregated (each call's ``w.numel()``)."""
    return dict(_EXCHANGES)


def reset_exchange_counts() -> None:
    for name in _EXCHANGES:
        _EXCHANGES[name] = 0


# the model axis's and the serving path's collectives in this process, by "{axis}_{op}" (axis "model" or
# "data"): calls and the bytes this rank puts in (each call's tensor, in the dtype it travels in)
_COLLECTIVES: dict[str, list[int]] = {}


def count_collective(axis: str, op: str, t: torch.Tensor) -> None:
    entry = _COLLECTIVES.setdefault(f"{axis}_{op}", [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def collective_counts() -> dict[str, dict[str, int]]:
    """A copy of the collective counts: ``{"model_all_reduce": {"calls",
    "bytes"}, ...}``, the bytes this rank put in."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(_COLLECTIVES.items())}


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def _dim_of(cut: tuple | None, axis: str) -> int | None:
    return None if cut is None or axis not in cut else cut.index(axis)


def _take(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``t`` along ``dim``."""
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size)


def _combine(site: _Site, dw_local: torch.Tensor, w_spec: tuple | None, cut: tuple | None = None) -> torch.Tensor:
    p, group, world = site.p, site.group, site.world
    n_local, w_shape = dw_local.shape[0], tuple(dw_local.shape[1:])
    if n_local != site.n_local:
        raise ValueError(f"{n_local} local blocks, expected {site.n_local} (N={p.n_devices} over {world} ranks)")
    tp_dim, data_dim = _dim_of(cut, "model"), _dim_of(cut, "data")
    rows = dw_local.to(torch.float32).reshape(n_local, -1)
    if not p.honest_mean:
        rows = _device_side(site, rows, w_shape, tp_dim)
    model_sum = () if tp_dim is None else (site.model_group,)  # a slice's Gram, summed over the model ranks
    dim = sharded_dim(w_spec, w_shape, world) if p.server == "sharded" and group is not None else None
    _EXCHANGES["gather_calls" if dim is None else "sharded_calls"] += 1
    _EXCHANGES["elements"] += rows.shape[1]
    if dim is None:  # gather: every rank aggregates all N rows
        stack = rows if group is None else _all_gather(rows, group, world)
        flat = stack if p.honest_mean else _server_side(p, stack)
        agg = (stable_mean0(flat) if p.honest_mean else _apply_rule(p, flat, model_sum)).reshape(w_shape)
        return agg if data_dim is None else _take(agg, data_dim, world, site.rank).contiguous()
    if data_dim not in (None, dim):
        raise ValueError(f"the leaf is stored cut on dim {data_dim}, the sharded server cuts dim {dim}")
    # sharded: the fsdp dim first, cut W ways, each rank receiving every row's cut of its own
    moved = rows.reshape((n_local,) + w_shape).movedim(1 + dim, 1)
    rest = tuple(moved.shape[2:])
    cut_len = w_shape[dim] // world
    send = moved.reshape((n_local, world, cut_len) + rest).transpose(0, 1).contiguous()  # (W, n_local, cut, ...)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)  # recv[s]: rank s's rows, this rank's cut
    flat = recv.reshape(p.n_devices, -1)
    if p.honest_mean:
        agg = stable_mean0(flat)
    else:
        agg = _apply_rule(p, _server_side(p, flat), (group,) + model_sum)
    agg = agg.reshape((cut_len,) + rest)
    if data_dim == dim:  # stored as this cut: no gather back
        return agg.movedim(0, dim).contiguous()
    whole = _all_gather(agg.unsqueeze(0), group, world)  # (W, cut, ...)
    return whole.reshape((w_shape[dim],) + rest).movedim(0, dim).contiguous()


# --- the ops ------------------------------------------------------------------


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows of a ``(V, D)`` table) as a one-hot product: the
    gather's values (each output one ``1.0 * w`` product plus exact zeros),
    with a matrix-product backward where a scatter-add's atomics on CUDA
    would add a token's gradients in an order that changes from run to run."""
    onehot = (ids[..., None] == torch.arange(table.shape[0], device=ids.device)).to(table.dtype)
    return onehot @ table


def _block(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] % n != 0:
        raise ValueError(f"leading axis {x.shape[0]} does not split into {n} device blocks")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _parse(spec: str) -> tuple[str, str, str]:
    operands, out = spec.replace(" ", "").split("->")
    lhs, rhs = operands.split(",")
    return lhs, rhs, out


def _product(spec: str, x: torch.Tensor, w: torch.Tensor, pre_blocked: bool) -> torch.Tensor:
    """``einsum(spec, x, w)``. A 2-D weight contracted with ``x``'s last
    axis (``...d,de->...e``, or ``...d,ed->...e`` against its transpose) is
    ``x @ w`` (``x @ w.T``), the product the models compute without the
    hooks: ``torch.einsum`` may order the same contraction as another GEMM,
    whose float32 rounding differs, and some float32 gradients are
    ill-conditioned enough to show it (ROADMAP C.7)."""
    lhs, rhs, out = _parse(spec)
    if w.ndim == 2 and not pre_blocked and len(rhs) == 2 and out == lhs[:-1] + rhs.replace(lhs[-1], "", 1):
        if rhs[0] == lhs[-1]:
            return x @ w
        if rhs[1] == lhs[-1]:
            return x @ w.T
    return torch.einsum(spec, x, w)


def _model_sum(t: torch.Tensor, site: _Site) -> torch.Tensor:
    """``t`` summed over the model group, in fp32, cast back."""
    total = t.to(torch.float32, copy=True)
    count_collective("model", "all_reduce", total)
    dist.all_reduce(total, group=site.model_group)
    return total.to(t.dtype)


def _compute_view(w: torch.Tensor, cut: tuple | None, site: _Site) -> torch.Tensor:
    """The stored cut ``w`` with its ``data`` cut all-gathered over the data
    group (its ``model`` cut kept): the weight an op computes with."""
    dim = _dim_of(cut, "data")
    if dim is None:
        return w
    parts = _all_gather(w.movedim(dim, 0), site.group, site.world)
    return parts.movedim(0, dim)


def _tp_kind(spec: str, cut: tuple | None) -> str | None:
    """``"column"`` when the weight's model-cut dim appears in the output,
    ``"row"`` when it is contracted, ``"expert"`` when the input and the
    output both carry it (MoE's experts), ``None`` when the weight is not
    cut over the model ranks."""
    dim = _dim_of(cut, "model")
    if dim is None:
        return None
    lhs, rhs, out = _parse(spec)
    letter = rhs[dim]
    if letter in out:
        return "expert" if letter in lhs else "column"
    if letter in lhs:
        return "row"
    raise ValueError(f"{spec}: the model-cut dim {letter!r} of the weight is summed away")


def _gather_dim(t: torch.Tensor, dim: int, site: _Site) -> torch.Tensor:
    """The model ranks' parts of ``t`` joined along ``dim``, in rank order."""
    count_collective("model", "all_gather", t)
    return _all_gather(t.movedim(dim, 0), site.model_group, site.model_world).movedim(0, dim).contiguous()


def _parts_view(w: torch.Tensor, dim: int, parts: int, site: _Site) -> torch.Tensor:
    """A leaf whose ``dim`` holds ``parts`` equal parts (Mamba's x and z
    halves of ``in_proj``), stored cut contiguously over the model ranks ->
    this rank's slice of every part, joined in part order."""
    whole = _gather_dim(w, dim, site)
    size = whole.shape[dim] // parts
    if size % site.model_world:
        raise ValueError(f"parts of {size} do not split over {site.model_world} model ranks")
    cut = size // site.model_world
    return torch.cat([whole.narrow(dim, j * size + site.model_rank * cut, cut) for j in range(parts)], dim)


def _parts_stored(t: torch.Tensor, dim: int, parts: int, site: _Site) -> torch.Tensor:
    """``_parts_view``'s inverse for a cotangent: every rank's slices of the
    parts -> this rank's contiguous stored cut."""
    m = site.model_world
    g = _gather_dim(t, dim, site).movedim(dim, 0)  # (m * parts * cut, ...): rank-major, then part
    cut = g.shape[0] // (m * parts)
    whole = g.reshape((m, parts, cut) + tuple(g.shape[1:])).transpose(0, 1).reshape(g.shape)
    return _take(whole, 0, m, site.model_rank).movedim(0, dim).contiguous()


class _PMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, spec, w_spec, pre_blocked, site, cut, parts):
        view = _compute_view(w, cut, site)
        kind = _tp_kind(spec, cut)
        tp_dim = _dim_of(cut, "model")
        if parts > 1 and tp_dim is not None:
            view = _parts_view(view, tp_dim, parts, site)
        ctx.save_for_backward(x, view)
        ctx.spec, ctx.w_spec, ctx.pre_blocked, ctx.site, ctx.cut, ctx.kind = spec, w_spec, pre_blocked, site, cut, kind
        ctx.parts = parts
        out = _product(spec, x, view, pre_blocked)
        return _model_sum(out, site) if kind == "row" else out

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        lhs, rhs, out = _parse(ctx.spec)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum(f"{out},{rhs}->{lhs}", ct, w).to(x.dtype)
            if ctx.kind == "column":  # each model rank holds its slice's share of dx
                dx = _model_sum(dx, ctx.site)
        if ctx.pre_blocked:  # the operands carry the device axis as their first index (MoE)
            dw_n = torch.einsum(f"{lhs},{out}->n{rhs}", x, ct)
        else:
            n = ctx.site.n_local
            dw_n = torch.einsum(f"n{lhs},n{out}->n{rhs}", _block(x, n), _block(ct, n))
        tp_dim = _dim_of(ctx.cut, "model")
        if ctx.parts > 1 and tp_dim is not None:
            dw_n = _parts_stored(dw_n, 1 + tp_dim, ctx.parts, ctx.site)
        dw = _combine(ctx.site, dw_n, ctx.w_spec, ctx.cut).to(w.dtype)
        return dx, dw, None, None, None, None, None, None


def pmm(spec: str, x: torch.Tensor, w: torch.Tensor, w_spec: tuple | None = None,
        pre_blocked: bool = False, parts: int = 1) -> torch.Tensor:
    """Protocol-aware ``einsum(spec, x, w)``, ``w`` the parameter (its
    stored cut under a context that cuts it).

    ``w_spec``, the parameter's logical axes, locates the ``fsdp`` dim the
    sharded server cuts (``None``: the leaf takes the gather server).
    ``pre_blocked``: the operands already carry the device axis ``n`` as
    their leading index (MoE's experts). ``parts``: the weight's model-cut
    dim holds that many equal parts (Mamba's ``in_proj``, x then z), and
    each rank computes with its slice of every part, not its contiguous
    stored cut; the cotangent goes back to the stored cut before the
    exchange. Where the model-cut dim is in the input and the output
    (``"expert"``), the input is this rank's cut of it (``model_split``)
    and nothing is exchanged between the model ranks."""
    ctx = current_protocol()
    if ctx is None:
        return _product(spec, x, w, pre_blocked)
    if pre_blocked and not spec.startswith("n"):
        raise ValueError(f"pre_blocked pmm needs an explicit n axis: {spec}")
    return _PMM.apply(x, w, spec, w_spec, pre_blocked, _take_site(), ctx.cut_of(w), parts)


class _FromData(torch.autograd.Function):
    """Forward, the compute view of a stored cut (``_compute_view``);
    backward, the view's gradient summed over the data group and cut back
    to the stored cut: the lookups' plain sum over every block."""

    @staticmethod
    def forward(ctx, w, cut, site):
        ctx.cut, ctx.site = cut, site
        view = _compute_view(w, cut, site)
        return w.view_as(w) if view is w else view

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.site.group)
        dim = _dim_of(ctx.cut, "data")
        return (g if dim is None else _take(g, dim, ctx.site.world, ctx.site.rank).contiguous()), None, None


class _ModelSum(torch.autograd.Function):
    """Forward, the sum over the model group (``_model_sum``); backward,
    the identity: the output's cotangent is the same on every model rank."""

    @staticmethod
    def forward(ctx, t, site):
        return _model_sum(t, site)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_rows(view: torch.Tensor, ids: torch.Tensor, site: _Site) -> torch.Tensor:
    """``lookup`` of the rows of ``view`` (this rank's vocabulary slice):
    an id outside it gives a row of exact zeros."""
    offset = site.model_rank * view.shape[0]
    onehot = (ids[..., None] == torch.arange(offset, offset + view.shape[0], device=ids.device)).to(view.dtype)
    return onehot @ view


def _check_vocab_cut(cut: tuple | None) -> bool:
    """Whether a table is cut over the model ranks (on its rows)."""
    dim = _dim_of(cut, "model")
    if dim not in (None, 0):
        raise ValueError(f"a table cut over the model ranks on dim {dim}: a lookup takes a cut of its rows only")
    return dim == 0


class _PLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, w_spec, site, cut):
        view = _compute_view(table, cut, site)
        ctx.save_for_backward(ids)
        ctx.w_spec, ctx.site, ctx.cut, ctx.shape, ctx.dtype = w_spec, site, cut, tuple(view.shape), table.dtype
        if _check_vocab_cut(cut):
            return _model_sum(_vocab_rows(view, ids, site), site)
        return lookup(view, ids)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        site, (v, d) = ctx.site, ctx.shape
        n = site.n_local
        offset = site.model_rank * v if _check_vocab_cut(ctx.cut) else 0
        idb = _block(ids.reshape(-1), n)  # (n, T/n)
        ctb = _block(ct.reshape(-1, d), n).to(torch.float32)  # (n, T/n, D)
        onehot = (idb[..., None] == torch.arange(offset, offset + v, device=ids.device)).to(torch.float32)
        dt_n = torch.einsum("ntv,ntd->nvd", onehot, ctb)  # each block's rows of the table, no scatter-add
        return _combine(site, dt_n, ctx.w_spec, ctx.cut).to(ctx.dtype), None, None, None, None


def plookup(table: torch.Tensor, ids: torch.Tensor, w_spec: tuple | None = None) -> torch.Tensor:
    """Protocol-aware ``table[ids]`` (``lookup``; vocabulary-parallel where
    the table's rows are cut over the model ranks). Its gradient aggregates
    by the plain sum over the blocks (summed over the ranks) unless
    ``embedding_robust`` is set."""
    ctx = current_protocol()
    if ctx is None:
        return lookup(table, ids)
    cut = ctx.cut_of(table)
    if ctx.p is not None and ctx.p.embedding_robust:
        return _PLookup.apply(table, ids, w_spec, _take_site(), cut)
    site = _site_of(ctx, 0)
    view = table if ctx.group is None else _FromData.apply(table, cut, site)
    if _check_vocab_cut(cut):
        return _ModelSum.apply(_vocab_rows(view, ids, site), site)
    return lookup(view, ids)


class _VocabLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, site):
        m = torch.amax(logits, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=site.model_group)
        total = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        dist.all_reduce(total, group=site.model_group)
        lse = m + torch.log(total)
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - lse[..., None]), None


def vocab_logsumexp(logits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits, -1)`` of fp32 ``logits = x @ table^T``: over the
    whole vocabulary where ``table``'s rows are cut over the model ranks
    (the max and the sum all-reduced over them)."""
    ctx = current_protocol()
    if ctx is None or not _check_vocab_cut(ctx.cut_of(table)):
        return torch.logsumexp(logits, dim=-1)
    return _VocabLSE.apply(logits, _site_of(ctx, 0))


def _affine_cut(ctx: _Context, x: torch.Tensor, w: torch.Tensor, index: int | None):
    """(the operand, its cut, the dims of a whole leaf to cut) of an affine
    op on ``w`` (row ``index`` of it where given): a model-cut leaf keeps
    its cut (a row, the row's), and a leaf that is whole where ``x`` holds
    this rank's cut of a dim is cut there (RWKV's ``w0`` and ``ln_scale``)."""
    cut = ctx.cut_of(w)
    if index is not None:
        w, cut = w[index], (None if cut is None else cut[1:] or None)
    local = ()
    if ctx.model_world > 1 and _dim_of(cut, "model") is None:
        local = tuple(d for d in range(w.ndim) if w.shape[d] != x.shape[x.ndim - w.ndim + d]
                      and w.shape[d] == ctx.model_world * x.shape[x.ndim - w.ndim + d])
        if len(local) > 1:
            raise ValueError(f"a whole {tuple(w.shape)} leaf on an input cut on more than one dim")
    return w, cut, local


class _PAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mode, site, cut, local):
        for d in local:  # this rank's cut of a whole leaf
            w = _take(w, d, site.model_world, site.model_rank)
        ctx.save_for_backward(x, w)
        ctx.mode, ctx.site, ctx.cut, ctx.local = mode, site, cut, local
        return x * w if mode == "mul" else x + w

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        mul = ctx.mode == "mul"
        dx = (ct * w if mul else ct).to(x.dtype) if ctx.needs_input_grad[0] else None
        cb = _block(ct * x if mul else ct, ctx.site.n_local)  # (n, B/n, ..., *w's broadcast dims)
        dw_n = torch.sum(cb.to(torch.float32), dim=tuple(range(1, cb.ndim - w.ndim))) if cb.ndim - w.ndim > 1 \
            else cb.to(torch.float32)
        for d in ctx.local:  # the whole leaf's blocked cotangent, on every model rank
            dw_n = _gather_dim(dw_n, 1 + d, ctx.site)
        return dx, _combine(ctx.site, dw_n, None, ctx.cut).to(w.dtype), None, None, None, None


def _affine(x: torch.Tensor, w: torch.Tensor, mode: str, index: int | None) -> torch.Tensor:
    ctx = current_protocol()
    if ctx is None:
        w = w if index is None else w[index]
        return x * w if mode == "mul" else x + w
    w, cut, local = _affine_cut(ctx, x, w, index)
    return _PAffine.apply(x, w, mode, _take_site(), cut, local)


def pscale(x: torch.Tensor, w: torch.Tensor, index: int | None = None) -> torch.Tensor:
    """Protocol-aware ``x * w`` (``x * w[index]``), ``w`` a parameter
    broadcast over trailing dims; under a context, a model-cut ``w`` keeps
    its cut in the exchange, and a whole ``w`` on an ``x`` cut over the
    model ranks is cut to match, its cotangent joined whole before it."""
    return _affine(x, w, "mul", index)


def pbias(x: torch.Tensor, w: torch.Tensor, index: int | None = None) -> torch.Tensor:
    """Protocol-aware ``x + w`` (``x + w[index]``), as ``pscale``."""
    return _affine(x, w, "add", index)


class _BlockTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, site, cut):
        ctx.site, ctx.cut = site, cut
        return w.unsqueeze(0).expand((site.n_local,) + tuple(w.shape)).clone()

    @staticmethod
    def backward(ctx, ct):
        # ct: (n, *w), each block's cotangent accumulated over its uses (a sequence loop)
        return _combine(ctx.site, ct, None, ctx.cut).to(ct.dtype), None, None


def block_tap(w: torch.Tensor, fn=None) -> tuple[torch.Tensor, int]:
    """A (small) parameter broadcast to one copy a local device block,
    ``(n, *w.shape)``, whose cotangent is aggregated once: for a parameter
    used inside a token loop (Mamba's A), where ``pscale`` would exchange a
    token. ``fn``: an elementwise transform of the leaf whose result is
    tapped (and exchanged), cut as the leaf is. Returns ``(w_b, n)``; with
    no active protocol ``(fn(w)[None], 1)``."""
    ctx = current_protocol()
    tapped = w if fn is None else fn(w)
    if ctx is None or ctx.p is None:  # no exchange: one copy
        return tapped[None], 1
    site = _take_site()
    return _BlockTap.apply(tapped, site, ctx.cut_of(w)), site.n_local


# --- the model ranks' activations ----------------------------------------------


def tp_dim_of(w: torch.Tensor) -> int | None:
    """The dim of the stored leaf ``w`` cut over the model ranks under the
    active context, or ``None`` (no context, or ``w`` whole there)."""
    ctx = current_protocol()
    return None if ctx is None else _dim_of(ctx.cut_of(w), "model")


def _model_site() -> _Site | None:
    ctx = current_protocol()
    return None if ctx is None or ctx.model_world == 1 else _site_of(ctx, 0)


class _Split(torch.autograd.Function):
    """Forward, this rank's part of a replicated tensor along ``dim``;
    backward, the ranks' parts of the cotangent gathered whole."""

    @staticmethod
    def forward(ctx, x, dim, site):
        ctx.dim, ctx.site = dim, site
        return _take(x, dim, site.model_world, site.model_rank).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.site), None, None


class _Join(torch.autograd.Function):
    """Forward, the ranks' parts gathered whole along ``dim``; backward,
    this rank's part of the cotangent: the same on every rank where what
    follows is replicated, or (``partial``) this rank's share of it, summed
    over the ranks first."""

    @staticmethod
    def forward(ctx, x, dim, site, partial):
        ctx.dim, ctx.site, ctx.partial = dim, site, partial
        return _gather_dim(x, dim, site)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _model_sum(g, ctx.site)
        return _take(g, ctx.dim, ctx.site.model_world, ctx.site.model_rank).contiguous(), None, None, None


class _GradSum(torch.autograd.Function):
    """Forward, the identity; backward, the cotangent summed over the model
    ranks (``sum_forward``: the forward too)."""

    @staticmethod
    def forward(ctx, x, site, sum_forward):
        ctx.site = site
        return _model_sum(x, site) if sum_forward else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.site), None, None


def model_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's part of the replicated ``x`` along ``dim`` (MoE's
    dispatch buffer cut to the rank's experts); ``x`` with no model ranks."""
    site = _model_site()
    return x if site is None else _Split.apply(x, dim, site)


def model_join(x: torch.Tensor, dim: int, partial: bool = False) -> torch.Tensor:
    """The model ranks' parts of ``x`` joined whole along ``dim``: MoE's
    expert outputs, RWKV's channel-mix receptance. ``partial``: what follows
    gives each rank only its share of the cotangent (RoPE on a cut
    ``head_dim``), so the backward sums it over the ranks first."""
    site = _model_site()
    return x if site is None else _Join.apply(x, dim, site, partial)


def model_grad_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, its cotangent summed over the model ranks: a replicated
    tensor that each rank reads only part of (the whole k and v under a cut
    of the q heads alone, Mamba's B and C under a cut ``d_inner``)."""
    site = _model_site()
    return x if site is None else _GradSum.apply(x, site, False)


def model_logits_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32 partial sums, the logits of a cut ``head_dim``) summed
    over the model ranks, its cotangent too."""
    site = _model_site()
    return x if site is None else _GradSum.apply(x, site, True)


def data_join(x: torch.Tensor) -> torch.Tensor:
    """Under a model context whose batch is cut over the data ranks, the
    data ranks' rows of ``x`` (its leading dim) gathered whole, in rank
    order; else ``x`` (forward only: the MoE routes the whole batch)."""
    ctx = current_protocol()
    if ctx is None or not ctx.batch_cut:
        return x
    count_collective("data", "all_gather", x)
    return _all_gather(x, ctx.group, ctx.world)


def data_part(x: torch.Tensor) -> torch.Tensor:
    """``data_join``'s inverse: this data rank's rows of a whole ``x``."""
    ctx = current_protocol()
    if ctx is None or not ctx.batch_cut:
        return x
    return _take(x, 0, ctx.world, ctx.rank)


def model_sum_fn():
    """A function summing an fp32 tensor over the model ranks (no autograd:
    the chunked attention's hand-written passes), or ``None``."""
    site = _model_site()
    return None if site is None else (lambda t: _model_sum(t, site))
