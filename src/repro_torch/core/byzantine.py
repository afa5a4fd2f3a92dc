"""The LAD / Com-LAD protocol round (Algorithms 1 and 2).

One round takes the gradient of every data subset and returns the server's
aggregate: task assignment, eq.-(5) encode (the gather-combine kernel),
compression (the quantize kernel for QSGD), Byzantine attack (the attack
kernel), then, under partial participation, the erasure of the rows that did
not report, and robust aggregation (the CWTM kernel, after NNM mixing around
the Gram kernel for ``-nnm`` rules; the masked-combine kernel for the K-of-N
erasure decode; group medians through the CWTM kernel for DRACO).

``method``:
  * ``"lad"``   — Algorithm 1/2 (Com-LAD when compression is on);
  * ``"plain"`` — the non-redundant baselines (VA / CWTM / CWTM-NNM /
                  Com-TGN): LAD with d = 1;
  * ``"draco"`` — DRACO [13]: fractional repetition (groups of ``d``
                  devices compute the same ``d`` subsets) and the group
                  majority-vote decode (``coding.draco_decode``); needs
                  ``d | N``.

The round draws nothing itself: its random choices come in as a
``RoundRandomness`` record, so a test can hand it the reference's own
draws and production draws them from a ``torch.Generator``.

The round takes a leading lane axis of independent scenarios: an ``(L, N,
Q)`` gradient stack with ``(L, ...)`` records gives ``(L, Q)`` aggregates,
and an ``(N, Q)`` stack is the ``L = 1`` case of the same code. The lanes
may split into ``LaneBranch`` runs of attacks and of servers: each attack
and each server is one call over its contiguous run of lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as attack_lib
from repro_torch.core import compression as comp_lib
from repro_torch.core import task_matrix as tm
from repro_torch.core.coding import coded_weights, cyclic_erasure_decode, draco_decode
from repro_torch.core.participation import ParticipationSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.numerics import stable_masked_mean0

__all__ = [
    "ProtocolConfig",
    "RoundRandomness",
    "LaneBranch",
    "sample_round_randomness",
    "draw_signature",
    "make_attack_fn",
    "make_server_fn",
    "protocol_round",
    "lad_round",
    "coded_draco_decode",
]


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """One protocol condition.

    Attributes:
      n_devices: ``N``, logical devices == data subsets.
      d: computational load, subsets per device per round (forced to 1 for
        ``method="plain"``; the group size for ``method="draco"``).
      method: ``"lad"``, ``"plain"`` or ``"draco"``.
      aggregator: any key of ``aggregators.AGGREGATORS``, optionally with
        ``-nnm``; or ``decode``, the K-of-N erasure decode, under an active
        participation schedule. DRACO's server is its own decode whatever
        the aggregator.
      trim_frac: CWTM trim fraction (``f = int(trim_frac * N)`` per side).
      n_byz: number of Byzantine devices ``N - H``.
      attack: the corruption model.
      compression: the Com-LAD wire compression.
      participation: the erasure fault model. ``"full"`` (the default)
        runs the unmasked round; any other schedule erases the rows that
        did not report and makes the server mask-aware (see
        ``make_server_fn``).
    """

    n_devices: int
    d: int = 1
    method: str = "lad"
    aggregator: str = "cwtm"
    trim_frac: float = 0.1
    n_byz: int = 0
    attack: attack_lib.AttackSpec = dataclasses.field(
        default_factory=lambda: attack_lib.AttackSpec(name="sign_flip")
    )
    compression: comp_lib.CompressionSpec = dataclasses.field(
        default_factory=comp_lib.CompressionSpec
    )
    participation: ParticipationSpec = dataclasses.field(default_factory=ParticipationSpec)

    def __post_init__(self):
        if self.method not in ("lad", "plain", "draco"):
            raise ValueError(f"unknown method {self.method!r}")

    def make_aggregator(self):
        return agg_lib.make_aggregator(
            self.aggregator, n_byz=self.n_byz, trim_frac=self.trim_frac
        )

    def effective_d(self) -> int:
        return 1 if self.method == "plain" else self.d


@dataclasses.dataclass(frozen=True)
class RoundRandomness:
    """Every random choice of one round. Every field may carry leading lane
    axes (one record per lane of a grid, or per round of
    ``engine.protocol_rounds``), the same on every field.

    Attributes:
      task_index: ``(N,)`` the task-matrix row each device runs;
        ``arange(N)`` under DRACO, which does not read it.
      subset_perm: ``(N,)`` the data subset behind each column (under DRACO
        the permutation whose consecutive blocks of ``d`` the groups take).
      byz_mask: ``(N,)`` 0/1 float, the Byzantine devices.
      keep_idx: ``(N, q_hat)`` each device's kept coordinates under sparse
        compression, else ``None``.
      quant_u: ``(N, Q)`` each device's QSGD rounding draws in [0, 1) under
        ``quant``, else ``None``.
      part_u: ``(N,)`` the participation schedule's draws in [0, 1) under an
        active schedule, else ``None``.
      attack_noise: ``(N, Q)`` standard normals under the ``gaussian``
        attack, else ``None``.
    """

    task_index: torch.Tensor
    subset_perm: torch.Tensor
    byz_mask: torch.Tensor
    keep_idx: torch.Tensor | None = None
    quant_u: torch.Tensor | None = None
    part_u: torch.Tensor | None = None
    attack_noise: torch.Tensor | None = None

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RoundRandomness":
        """``fn`` applied to every field that is not ``None``."""
        return RoundRandomness(**{
            f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
        })

    def to(self, device: torch.device | str) -> "RoundRandomness":
        return self.map(lambda v: v.to(device))

    @staticmethod
    def stack(records: "list[RoundRandomness]") -> "RoundRandomness":
        """The records as one record with a new leading axis."""
        return RoundRandomness(**{
            f.name: None if getattr(records[0], f.name) is None
            else torch.stack([getattr(r, f.name) for r in records])
            for f in dataclasses.fields(RoundRandomness)
        })

    def validate(self, n: int, q: int) -> None:
        """Raise unless this is a well-formed round for ``N = n`` devices and
        width ``q``: both assignment draws permutations of ``[0, n)``, a 0/1
        mask of ``n`` devices, keep-indices in ``[0, q)``, uniforms in
        ``[0, 1)`` of shape ``(n, q)`` (``quant_u``) and ``(n,)``
        (``part_u``), finite float32 normals of shape ``(n, q)``
        (``attack_noise``); each with the same leading lane axes, if any.

        Reads the tensors on the host (a device sync when they lie on a
        card); ``sample_round_randomness`` needs no check, a record built
        anywhere else is checked once where it enters the trainer."""
        lead = tuple(self.task_index.shape[:-1])
        ids = torch.arange(n)
        for name in ("task_index", "subset_perm"):
            t = getattr(self, name).cpu()
            if t.shape != lead + (n,) or not bool((torch.sort(t.long(), dim=-1).values == ids).all()):
                raise ValueError(f"RoundRandomness.{name} is not a permutation of [0, {n})")
        mask = self.byz_mask.cpu()
        if mask.shape != lead + (n,) or not bool(((mask == 0) | (mask == 1)).all()):
            raise ValueError(f"RoundRandomness.byz_mask must be ({n},) 0/1")
        if self.keep_idx is not None:
            keep = self.keep_idx.cpu()
            if keep.shape[:-1] != lead + (n,) or (
                    keep.numel() and (int(keep.min()) < 0 or int(keep.max()) >= q)):
                raise ValueError(f"RoundRandomness.keep_idx must be ({n}, q_hat) ids in [0, {q})")
        for name, shape in (("quant_u", (n, q)), ("part_u", (n,))):
            u = getattr(self, name)
            if u is not None and (u.shape != lead + shape or u.dtype != torch.float32
                                  or not bool(((u >= 0) & (u < 1)).all())):
                raise ValueError(f"RoundRandomness.{name} must be {shape} float32 in [0, 1)")
        noise = self.attack_noise
        if noise is not None and (noise.shape != lead + (n, q) or noise.dtype != torch.float32
                                  or not bool(torch.isfinite(noise).all())):
            raise ValueError(f"RoundRandomness.attack_noise must be ({n}, {q}) finite float32")


def sample_round_randomness(cfg: ProtocolConfig, q: int, generator: torch.Generator) -> RoundRandomness:
    """Draw one round's randomness from ``generator`` on its device."""
    n = cfg.n_devices
    dev = generator.device
    if cfg.method == "draco":
        ta = tm.fractional_repetition(torch.randperm(n, generator=generator, device=dev), cfg.d)
        task_index = torch.arange(n, device=dev)
    else:
        ta = tm.sample_assignment(generator, n, cfg.effective_d())
        task_index = ta.task_index
    mask = attack_lib.sample_byzantine_mask(
        n, cfg.n_byz, fixed=cfg.attack.fixed_identity, generator=generator,
        device=generator.device,
    )
    keep_idx = comp_lib.sample_keep_idx(cfg.compression, n, q, generator)
    quant_u = comp_lib.sample_quant_u(cfg.compression, n, q, generator)
    part_u = None
    if cfg.participation.active:
        part_u = torch.rand((n,), generator=generator, device=dev)
    attack_noise = None
    if cfg.attack.name == "gaussian":
        attack_noise = torch.randn((n, q), generator=generator, device=dev)
    return RoundRandomness(
        task_index=task_index,
        subset_perm=ta.subset_perm,
        byz_mask=mask,
        keep_idx=keep_idx,
        quant_u=quant_u,
        part_u=part_u,
        attack_noise=attack_noise,
    )


@dataclasses.dataclass(frozen=True)
class LaneBranch:
    """The lanes ``[start, stop)`` of a batched round and the attack or the
    server they run (``make_attack_fn`` / ``make_server_fn`` of their
    configuration): one call over that slice of lanes."""

    start: int
    stop: int
    fn: Callable


def _branches(given: tuple[LaneBranch, ...] | None, make: Callable[[], Callable],
              lanes: int) -> tuple[LaneBranch, ...]:
    """``given``, checked to cover lanes ``[0, lanes)`` in consecutive runs,
    or one run of ``make()`` over them all."""
    runs = given if given is not None else (LaneBranch(0, lanes, make()),)
    if runs[0].start != 0 or runs[-1].stop != lanes or any(a.stop != b.start for a, b in zip(runs, runs[1:])):
        raise ValueError(f"branches must cover lanes [0, {lanes}) in consecutive runs")
    return runs


def draw_signature(cfg: ProtocolConfig) -> tuple:
    """What decides which tensors ``sample_round_randomness`` draws for
    ``cfg``, and in what order: configurations with the same signature draw
    the same records from generators seeded alike."""
    return (cfg.n_devices, cfg.method, cfg.effective_d(), cfg.n_byz, cfg.attack.fixed_identity,
            cfg.compression, cfg.participation.active, cfg.attack.name == "gaussian")


def make_attack_fn(cfg: ProtocolConfig) -> attack_lib.Attack:
    """The corruption map ``(msgs, mask, noise) -> transmitted`` of ``cfg``."""
    return dataclasses.replace(cfg.attack, n_byz=cfg.n_byz).make()


def _masked_server_fn(cfg: ProtocolConfig) -> Callable:
    """The participation-aware server ``(transmitted (..., N, Q), pmask (...,
    N), task_index (..., N)) -> (..., Q)``, in three regimes:

      * ``aggregator="decode"``: the cyclic K-of-N erasure decode, exact
        while the erasures stay within the margin ``d - 1`` (needs ``d |
        N``);
      * ``method="draco"``: DRACO's median over reporting group members
        (``coding.draco_decode`` with the mask);
      * any other rule, impute-then-aggregate: erased rows are replaced by
        the reporting rows' mean and the full-participation rule runs on the
        patched stack. At an all-ones mask the select changes nothing and
        the rule sees the unmasked stack bit for bit.
    """
    if cfg.aggregator == "decode":
        if cfg.method == "draco":
            raise ValueError(
                "aggregator='decode' is the cyclic erasure decode, incompatible with "
                "method='draco' (which has its own masked decoder)"
            )
        d = cfg.effective_d()
        if cfg.n_devices % d != 0:
            raise ValueError(
                f"aggregator='decode' exactness needs d | N (the offset classes must tile "
                f"the subset circle): N={cfg.n_devices} d={d}"
            )
        return lambda t, pm, task_index: cyclic_erasure_decode(t, pm, task_index, d)
    if cfg.method == "draco":
        return lambda t, pm, task_index: draco_decode(t, cfg.d, mask=pm)
    base = cfg.make_aggregator()

    def masked_server(t: torch.Tensor, pm: torch.Tensor, task_index: torch.Tensor) -> torch.Tensor:
        del task_index
        imputed = stable_masked_mean0(t, pm, dim=-2)
        return base(torch.where(pm[..., None] > 0.0, t, imputed[..., None, :]))

    return masked_server


def make_server_fn(cfg: ProtocolConfig) -> Callable:
    """The server of ``cfg``, over any leading lane axes. At full
    participation ``(..., N, Q) -> (..., Q)``: CWTM
    and ``median`` run through the CWTM kernel, the ``-nnm`` rules and Krum
    through the Gram kernel (see ``aggregators``), DRACO is its group
    decode (``coding.draco_decode``). Under an active participation schedule
    ``(transmitted, pmask, task_index) -> (..., Q)`` (see
    ``_masked_server_fn``)."""
    if cfg.participation.active:
        return _masked_server_fn(cfg)
    if cfg.aggregator == "decode":
        raise ValueError(
            "aggregator='decode' (the K-of-N erasure decode) needs an active participation "
            "schedule; at full participation the mean server recovers the same gradient mean"
        )
    if cfg.method == "draco":
        return lambda t: draco_decode(t, cfg.d)
    return cfg.make_aggregator()


def protocol_round(
    cfg: ProtocolConfig,
    subset_grads: torch.Tensor,
    rand: RoundRandomness,
    *,
    device: torch.device | str | None = None,
    attack_branches: tuple[LaneBranch, ...] | None = None,
    server_branches: tuple[LaneBranch, ...] | None = None,
    participation_mask: torch.Tensor | None = None,
    stage_hook: Callable[[str], None] | None = None,
) -> torch.Tensor:
    """One full protocol round, over a leading lane axis of independent
    scenarios.

    Args:
      cfg: protocol configuration (the lanes' shared static structure).
      subset_grads: ``(L, N, Q)`` fp32, the gradient of every data subset in
        every lane; an ``(N, Q)`` stack is the ``L = 1`` case (its records
        and mask carry no lane axis, and the result is ``(Q,)``).
      rand: this round's random choices, ``(L, ...)`` on the round's device.
      device: where the round runs; ``cuda`` when not given (no CUDA then
        raises). ``subset_grads`` must already lie there.
      attack_branches / server_branches: consecutive ``LaneBranch`` runs
        that cover ``[0, L)``, each with its own attack (server); when not
        given, ``make_attack_fn(cfg)`` (``make_server_fn(cfg)``) runs on
        every lane. The attacks' outputs are joined into one stack when
        there are several runs.
      participation_mask: ``(L, N)`` 0/1 float mask of the reporting
        devices; needs an active ``cfg.participation``, where ``None``
        means every device reports through the masked path. The erased rows
        are zeroed after the attack (the collusion statistics see the whole
        stack; an erased attacker sends nothing) and the mask-aware server
        decodes the rest.
      stage_hook: called with ``"encode"``, ``"compress"``, ``"attack"``,
        ``"erase"`` (active participation only) and ``"server"`` as each
        stage has been enqueued (for stage timing).

    Returns:
      ``(L, Q)`` the aggregates ``g^t`` (``(Q,)`` for an ``(N, Q)`` stack).
    """
    if subset_grads.ndim == 2:
        return protocol_round(
            cfg, subset_grads[None], rand.map(lambda v: v[None]), device=device,
            attack_branches=attack_branches, server_branches=server_branches, stage_hook=stage_hook,
            participation_mask=None if participation_mask is None else participation_mask[None])[0]
    dev = resolve_device(device)
    n = cfg.n_devices
    if subset_grads.device != dev:
        raise ValueError(f"subset_grads lie on {subset_grads.device}, the round runs on {dev}")
    if subset_grads.ndim != 3 or subset_grads.shape[1] != n:
        raise ValueError(f"subset_grads must be (L, {n}, Q) or ({n}, Q), got {tuple(subset_grads.shape)}")
    lanes = subset_grads.shape[0]
    active = cfg.participation.active
    if participation_mask is not None and not active:
        raise ValueError("participation_mask passed but cfg.participation is 'full'")
    attacks = _branches(attack_branches, lambda: make_attack_fn(cfg), lanes)
    servers = _branches(server_branches, lambda: make_server_fn(cfg), lanes)
    hook = stage_hook or (lambda stage: None)

    d = cfg.effective_d()
    if cfg.method == "draco":
        assign = tm.fractional_repetition(rand.subset_perm, d)
    else:
        assign = tm.assignment_from(rand.task_index, rand.subset_perm, d)
    coded = kernel_ops.gather_combine(subset_grads, assign.subsets, coded_weights(d, dev))
    hook("encode")

    coded = comp_lib.compress_rows(cfg.compression, coded, rand.keep_idx, rand.quant_u)
    hook("compress")

    noise = rand.attack_noise
    parts = [b.fn(coded[b.start:b.stop], rand.byz_mask[b.start:b.stop],
                  None if noise is None else noise[b.start:b.stop]) for b in attacks]
    del coded  # free the coded stack before the server allocates
    transmitted = parts[0] if len(parts) == 1 else torch.cat(parts)
    del parts
    hook("attack")

    if not active:
        out = [b.fn(transmitted[b.start:b.stop]) for b in servers]
    else:
        pm = participation_mask
        if pm is None:
            pm = torch.ones((lanes, n), dtype=torch.float32, device=dev)
        # erased rows become exact 0.0; x * 1.0 leaves the others' bits
        transmitted = transmitted * pm[..., None]
        hook("erase")
        out = [b.fn(transmitted[b.start:b.stop], pm[b.start:b.stop], assign.task_index[b.start:b.stop])
               for b in servers]
    hook("server")
    return out[0] if len(out) == 1 else torch.cat(out)


def coded_draco_decode(transmitted: torch.Tensor, d: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """DRACO's majority-vote decode of a round's transmitted stack
    (``coding.draco_decode``), under the reference's name."""
    return draco_decode(transmitted, d, mask=mask)


def lad_round(cfg: ProtocolConfig, params: torch.Tensor, subset_grad_fn: Callable[[torch.Tensor], torch.Tensor],
              rand: RoundRandomness, *, device: torch.device | str | None = None) -> torch.Tensor:
    """Every subset gradient at ``params`` (``subset_grad_fn(params) -> (N,
    Q)``), then one ``protocol_round`` on them with the round's records
    ``rand``."""
    return protocol_round(cfg, subset_grad_fn(params), rand, device=device)
