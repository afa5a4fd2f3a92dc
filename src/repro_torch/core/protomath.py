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

Each exchanged call site draws from generators seeded by ``(seed, site,
row, stream)``, ``seed`` the round's (``protocol_context``) and ``site``
the call's order in one forward; a loop over periods, encoder layers or
loss chunks shares its body's sites (``shared_sites``), as the reference's
scans trace their body once. The reference folds a process-global trace
counter into its keys instead (ROADMAP C.9), so its draws cannot be
replayed: the gaussian attack and the compressors are held to it
statistically. With no active context every helper is the plain op.
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

__all__ = ["BlockedProtocol", "protocol_context", "current_protocol", "shared_sites", "fold_seed", "sharded_dim",
           "robust_combine", "exchange_counts", "reset_exchange_counts", "lookup", "pmm", "plookup", "pscale",
           "pbias", "block_tap"]

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
    model_size: int = 1  # the "model" axis: tensor parallelism waits for ROADMAP A.9c
    # Lookup gradients are sparse over the vocabulary, so a coordinate-wise
    # trimmed mean would trim their signal away: by default they aggregate
    # by the plain sum, as in the reference; True exchanges them too.
    embedding_robust: bool = False

    def __post_init__(self):
        if self.model_size != 1:
            raise ValueError(f"model_size={self.model_size}: the tensor-parallel model axis waits for ROADMAP A.9c")
        if self.server not in ("sharded", "gather"):
            raise ValueError(f"unknown server {self.server!r}: expected 'sharded' or 'gather'")


# --- context ----------------------------------------------------------------


@dataclasses.dataclass
class _Context:
    p: BlockedProtocol
    seed: int
    group: Any  # a torch.distributed process group, or None: one rank, no collectives
    world: int
    rank: int
    site: int = 0


_ACTIVE: list[_Context] = []


def _world_rank(group: Any) -> tuple[int, int]:
    return (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))


@contextmanager
def protocol_context(p: BlockedProtocol, seed: int, group: Any = None):
    """Activate the LAD exchange for every protomath call inside, under the
    round's ``seed``, over the data ``group`` (``None``: this process holds
    all ``N`` blocks and makes no collective call)."""
    world, rank = _world_rank(group)
    if p.n_devices % world != 0:
        raise ValueError(f"N={p.n_devices} blocks do not split over {world} ranks")
    _ACTIVE.append(_Context(p, int(seed), group, world, rank))
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

    @property
    def n_local(self) -> int:
        return self.p.n_devices // self.world

    def generator(self, row: int, stream: int, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(fold_seed(self.seed, row, stream))


def _take_site() -> _Site:
    ctx = _ACTIVE[-1]
    site = _Site(ctx.p, fold_seed(ctx.seed, ctx.site), ctx.group, ctx.world, ctx.rank)
    ctx.site += 1
    return site


# --- aggregation over the device axis -----------------------------------------


def _trim_count(p: BlockedProtocol) -> int:
    f = int(p.trim_frac * p.n_devices)
    return min(f, (p.n_devices - 1) // 2)


def _apply_rule(p: BlockedProtocol, flat: torch.Tensor, gram_group: Any = None) -> torch.Tensor:
    """(N, Q) fp32 -> (Q,). NNM's distances come from the Gram kernel
    (summed over ``gram_group`` when the columns are a cut), its
    neighbours by a stable sort, its mix inside the CWTM kernel."""
    name, n = p.aggregator, flat.shape[0]
    table = None
    if name.endswith("-nnm"):
        name = name[: -len("-nnm")]
        gram, sq = kernel_ops.gram(flat)
        if gram_group is not None:
            dist.all_reduce(gram, group=gram_group)
            dist.all_reduce(sq, group=gram_group)
        table = aggregators.nnm_neighbours(sqdist_from_gram(gram, sq), p.n_byz)
    if name == "mean":
        return stable_mean0(flat) if table is None else kernel_ops.cwtm(flat, 0, table)
    if name == "median":
        return kernel_ops.cwtm(flat, (n - 1) // 2, table)
    if name == "cwtm":
        return kernel_ops.cwtm(flat, _trim_count(p), table)
    raise KeyError(f"blocked protocol supports mean/median/cwtm[-nnm], got {p.aggregator!r}")


def _device_side(site: _Site, rows: torch.Tensor) -> torch.Tensor:
    """Compression, then the ``gaussian`` attack, of this rank's (n_local,
    Q) fp32 rows; row ``i`` is global block ``rank * n_local + i`` and draws
    from its own generators."""
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
                   group: Any = None) -> torch.Tensor:
    """The server: this rank's blocked cotangent ``(N/W, *w)`` -> the
    aggregate ``(*w)`` in fp32, the same on every rank of ``group``."""
    return _combine(_Site(p, seed, group, *_world_rank(group)), dw_local, w_spec)


# exchanges in this process, by server: calls and the parameters they aggregated
_EXCHANGES = {"sharded_calls": 0, "gather_calls": 0, "elements": 0}


def exchange_counts() -> dict[str, int]:
    """A copy of the exchange counts: ``sharded_calls``, ``gather_calls``
    and ``elements``, the parameters aggregated (each call's ``w.numel()``)."""
    return dict(_EXCHANGES)


def reset_exchange_counts() -> None:
    for name in _EXCHANGES:
        _EXCHANGES[name] = 0


def _combine(site: _Site, dw_local: torch.Tensor, w_spec: tuple | None) -> torch.Tensor:
    p, group, world = site.p, site.group, site.world
    n_local, w_shape = dw_local.shape[0], tuple(dw_local.shape[1:])
    if n_local != site.n_local:
        raise ValueError(f"{n_local} local blocks, expected {site.n_local} (N={p.n_devices} over {world} ranks)")
    rows = dw_local.to(torch.float32).reshape(n_local, -1)
    if not p.honest_mean:
        rows = _device_side(site, rows)
    dim = sharded_dim(w_spec, w_shape, world) if p.server == "sharded" and group is not None else None
    _EXCHANGES["gather_calls" if dim is None else "sharded_calls"] += 1
    _EXCHANGES["elements"] += rows.shape[1]
    if dim is None:  # gather: every rank aggregates all N rows
        stack = rows if group is None else _all_gather(rows, group, world)
        flat = stack if p.honest_mean else _server_side(p, stack)
        agg = stable_mean0(flat) if p.honest_mean else _apply_rule(p, flat)
        return agg.reshape(w_shape)
    # sharded: the fsdp dim first, cut W ways, each rank receiving every row's cut of its own
    moved = rows.reshape((n_local,) + w_shape).movedim(1 + dim, 1)
    rest = tuple(moved.shape[2:])
    cut = w_shape[dim] // world
    send = moved.reshape((n_local, world, cut) + rest).transpose(0, 1).contiguous()  # (W, n_local, cut, ...)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)  # recv[s]: rank s's rows, this rank's cut
    flat = recv.reshape(p.n_devices, -1)
    if p.honest_mean:
        agg = stable_mean0(flat)
    else:
        agg = _apply_rule(p, _server_side(p, flat), gram_group=group)
    whole = _all_gather(agg.reshape((1, cut) + rest), group, world)  # (W, cut, ...)
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


class _PMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, spec, w_spec, pre_blocked, site):
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.w_spec, ctx.pre_blocked, ctx.site = spec, w_spec, pre_blocked, site
        return _product(spec, x, w, pre_blocked)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        lhs, rhs, out = _parse(ctx.spec)
        dx = torch.einsum(f"{out},{rhs}->{lhs}", ct, w).to(x.dtype) if ctx.needs_input_grad[0] else None
        if ctx.pre_blocked:  # the operands carry the device axis as their first index (MoE)
            dw_n = torch.einsum(f"{lhs},{out}->n{rhs}", x, ct)
        else:
            n = ctx.site.n_local
            dw_n = torch.einsum(f"n{lhs},n{out}->n{rhs}", _block(x, n), _block(ct, n))
        dw = _combine(ctx.site, dw_n, ctx.w_spec).to(w.dtype)
        return dx, dw, None, None, None, None


def pmm(spec: str, x: torch.Tensor, w: torch.Tensor, w_spec: tuple | None = None,
        pre_blocked: bool = False) -> torch.Tensor:
    """Protocol-aware ``einsum(spec, x, w)``, ``w`` the parameter.

    ``w_spec``, the parameter's logical axes, locates the ``fsdp`` dim the
    sharded server cuts (``None``: the leaf takes the gather server).
    ``pre_blocked``: the operands already carry the device axis ``n`` as
    their leading index (MoE's experts)."""
    ctx = current_protocol()
    if ctx is None:
        return _product(spec, x, w, pre_blocked)
    if pre_blocked and not spec.startswith("n"):
        raise ValueError(f"pre_blocked pmm needs an explicit n axis: {spec}")
    return _PMM.apply(x, w, spec, w_spec, pre_blocked, _take_site())


class _RankSum(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _PLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, w_spec, site):
        ctx.save_for_backward(ids)
        ctx.w_spec, ctx.site, ctx.shape, ctx.dtype = w_spec, site, tuple(table.shape), table.dtype
        return lookup(table, ids)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        n, (v, d) = ctx.site.n_local, ctx.shape
        idb = _block(ids.reshape(-1), n)  # (n, T/n)
        ctb = _block(ct.reshape(-1, d), n).to(torch.float32)  # (n, T/n, D)
        onehot = (idb[..., None] == torch.arange(v, device=ids.device)).to(torch.float32)
        dt_n = torch.einsum("ntv,ntd->nvd", onehot, ctb)  # each block's rows of the table, no scatter-add
        return _combine(ctx.site, dt_n, ctx.w_spec).to(ctx.dtype), None, None, None


def plookup(table: torch.Tensor, ids: torch.Tensor, w_spec: tuple | None = None) -> torch.Tensor:
    """Protocol-aware ``table[ids]`` (``lookup``). Its gradient aggregates
    by the plain sum over the blocks (summed over the ranks) unless
    ``embedding_robust`` is set."""
    ctx = current_protocol()
    if ctx is None:
        return lookup(table, ids)
    if not ctx.p.embedding_robust:
        return lookup(table if ctx.group is None else _RankSum.apply(table, ctx.group), ids)
    return _PLookup.apply(table, ids, w_spec, _take_site())


class _PAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mode, site):
        ctx.save_for_backward(x, w)
        ctx.mode, ctx.site = mode, site
        return x * w if mode == "mul" else x + w

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        mul = ctx.mode == "mul"
        dx = (ct * w if mul else ct).to(x.dtype) if ctx.needs_input_grad[0] else None
        cb = _block(ct * x if mul else ct, ctx.site.n_local)  # (n, B/n, ..., *w's broadcast dims)
        dw_n = torch.sum(cb.to(torch.float32), dim=tuple(range(1, cb.ndim - w.ndim))) if cb.ndim - w.ndim > 1 \
            else cb.to(torch.float32)
        return dx, _combine(ctx.site, dw_n, None).to(w.dtype), None, None


def pscale(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Protocol-aware ``x * w``, ``w`` broadcast over trailing dims."""
    if current_protocol() is None:
        return x * w
    return _PAffine.apply(x, w, "mul", _take_site())


def pbias(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Protocol-aware ``x + w``, ``w`` broadcast over trailing dims."""
    if current_protocol() is None:
        return x + w
    return _PAffine.apply(x, w, "add", _take_site())


class _BlockTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, site):
        ctx.site = site
        return w.unsqueeze(0).expand((site.n_local,) + tuple(w.shape)).clone()

    @staticmethod
    def backward(ctx, ct):
        # ct: (n, *w), each block's cotangent accumulated over its uses (a sequence loop)
        return _combine(ctx.site, ct, None).to(ct.dtype), None


def block_tap(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (small) parameter broadcast to one copy a local device block,
    ``(n, *w.shape)``, whose cotangent is aggregated once: for a parameter
    used inside a token loop (Mamba's A), where ``pscale`` would exchange a
    token. Returns ``(w_b, n)``; with no active protocol ``(w[None], 1)``."""
    ctx = current_protocol()
    if ctx is None:
        return w[None], 1
    site = _take_site()
    return _BlockTap.apply(w, site), site.n_local
