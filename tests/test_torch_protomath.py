"""The port's per-parameter exchange (``repro_torch.core.protomath``)
against the reference's ``repro.core.protomath`` on the CPU.

The reference runs under ``protocol_context`` on a 1 x 1 mesh whose axes
are ``Auto`` (jax's default ``Explicit`` axes refuse its sharding
constraints, ROADMAP C.4), with ``BlockedProtocol(n_devices=4)``; the port
in one process (no data group) with the same protocol. Both take the same
inputs, drawn with numpy.

  * Each op (``pmm`` plain and ``pre_blocked``, ``plookup`` with and
    without ``embedding_robust``, ``pscale``, ``pbias``, ``block_tap``):
    its forward and both gradients, across the aggregators ``mean``,
    ``median``, ``cwtm`` and ``cwtm-nnm``, the key-free attacks ``none``,
    ``sign_flip``, ``alie``, ``ipm``, ``zero`` and ``label_shift``, and
    both servers (one process holds every block, so the two are the same
    computation on either side; ``tests/test_torch_protomath_step.py``
    holds them across ranks).
  * The whole model's gradient under the exchange, leaf by leaf, for
    ``reduced(smollm-360m)`` and each ``zoo_arch`` family.
  * The scale of the exchanged gradients (ROADMAP C.8): the honest mean
    is ``1/N`` of the plain gradient, the lookups' plain sum is not
    scaled, so the tied table mixes the two; the port computes what the
    reference computes.
  * The gaussian attack and the compressors, whose draws the reference
    keys on a process-global trace counter (ROADMAP C.9), statistically:
    which rows change, the noise's moments, each compressor's support and
    its unbiasedness over draws.

Tolerance: rtol 1e-5 with atol 1e-6 of the leaf's (or output's) largest
magnitude for the ops. The whole-model gradients are sums over a network
whose float32 rounding the two frameworks order differently: they are held
to rtol 1e-5 with atol 1e-5 of each leaf's largest magnitude, the standard
tests/test_torch_zoo_ops.py measured for the same gradients outside the
exchange.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import models as jmodels
from repro.configs.archs import ARCHS as JARCHS
from repro.configs.archs import reduced as jreduced
from repro.core import attacks as jattacks
from repro.core import compression as jcomp
from repro.core import protomath as J
from repro.core import scenarios as jscn
from repro_torch import convert, models, pytree
from repro_torch.configs.archs import ARCHS as TARCHS
from repro_torch.configs.archs import reduced as treduced
from repro_torch.core import attacks as tattacks
from repro_torch.core import compression as tcomp
from repro_torch.core import protomath as T
from repro_torch.core import scenarios as tscn

N = 4
RTOL, ATOL_FRAC = 1e-5, 1e-6
GRAD_ATOL_FRAC = 1e-5  # whole-model gradients: tests/test_torch_zoo_ops.py's measured standard
AGGS = ("mean", "median", "cwtm", "cwtm-nnm")
ATTACKS = ("none", "sign_flip", "alie", "ipm", "zero", "label_shift")
SERVERS = ("sharded", "gather")


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:1])


def protocols(agg="cwtm", attack="alie", server="gather", n_byz=1, compression=None, **kw):
    """The same protocol on both sides, (reference, port); ``compression``
    a dict of ``CompressionSpec`` fields."""
    common = dict(n_devices=N, aggregator=agg, trim_frac=0.25, n_byz=n_byz, server=server, **kw)
    jextra = {} if compression is None else {"compression": jcomp.CompressionSpec(**compression)}
    textra = {} if compression is None else {"compression": tcomp.CompressionSpec(**compression)}
    jp = J.BlockedProtocol(**common, attack=jattacks.AttackSpec(name=attack, n_byz=n_byz), **jextra)
    tp = T.BlockedProtocol(**common, attack=tattacks.AttackSpec(name=attack, n_byz=n_byz), **textra)
    return jp, tp


def close(got: torch.Tensor, want, rtol=RTOL, atol_frac=ATOL_FRAC, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol_frac * scale, err_msg=what)


# ---------------------------------------------------------------------- ops


def _op_inputs(op: str, rng):
    """An op's operands: float32 arrays, and the lookup's int32 ids."""
    f32 = np.float32
    if op == "pmm":
        return [rng.standard_normal((8, 5, 6)).astype(f32), rng.standard_normal((6, 7)).astype(f32)]
    if op == "pmm_pre_blocked":
        return [rng.standard_normal((N, 3, 6)).astype(f32), rng.standard_normal((6, 5)).astype(f32)]
    if op.startswith("plookup"):
        return [rng.standard_normal((11, 6)).astype(f32), rng.integers(0, 11, (8, 5)).astype(np.int32)]
    if op in ("pscale", "pbias"):
        return [rng.standard_normal((8, 5, 6)).astype(f32), rng.standard_normal((6,)).astype(f32)]
    if op == "block_tap":
        return [rng.standard_normal((6, 3)).astype(f32)]
    raise KeyError(op)


def _jop(op, args):
    if op == "pmm":
        return J.pmm("bsd,df->bsf", args[0], args[1], w_spec=("fsdp", None))
    if op == "pmm_pre_blocked":
        return J.pmm("ntd,de->nte", args[0], args[1], w_spec=("fsdp", None), pre_blocked=True)
    if op.startswith("plookup"):
        return J.plookup(args[0], args[1], w_spec=("tp", "fsdp"))
    if op == "pscale":
        return J.pscale(args[0], args[1])
    if op == "pbias":
        return J.pbias(args[0], args[1])
    return J.block_tap(args[0])[0]


def _top(op, args):
    if op == "pmm":
        return T.pmm("bsd,df->bsf", args[0], args[1], w_spec=("fsdp", None))
    if op == "pmm_pre_blocked":
        return T.pmm("ntd,de->nte", args[0], args[1], w_spec=("fsdp", None), pre_blocked=True)
    if op.startswith("plookup"):
        return T.plookup(args[0], args[1], w_spec=("tp", "fsdp"))
    if op == "pscale":
        return T.pscale(args[0], args[1])
    if op == "pbias":
        return T.pbias(args[0], args[1])
    return T.block_tap(args[0])[0]


def _run_op(mesh, op, jp, tp):
    """Forward and the gradients of ``sum(out * ct)`` on both sides:
    ((out, grads) reference, (out, grads) port)."""
    rng = np.random.default_rng(OPS.index(op))
    arrays = _op_inputs(op, rng)
    diff = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    with mesh:
        out_shape = jax.eval_shape(lambda *a: _jop(op, a), *arrays).shape
    ct = rng.standard_normal(out_shape).astype(np.float32)

    def jloss(*floats):
        args = list(arrays)
        for i, a in zip(diff, floats):
            args[i] = a
        with J.protocol_context(jp, jax.random.PRNGKey(0)):
            out = _jop(op, args)
        return jnp.sum(out * ct), out

    with mesh:
        (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(diff))), has_aux=True)(
            *[arrays[i] for i in diff])
    targs = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    with T.protocol_context(tp, 0):
        tout = _top(op, targs)
    (tout * torch.tensor(ct)).sum().backward()
    return (jout, jgrads), (tout, [targs[i].grad for i in diff])


OPS = ("pmm", "pmm_pre_blocked", "plookup_robust", "plookup_plain", "pscale", "pbias", "block_tap")


@pytest.mark.parametrize("attack", ATTACKS)
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("op", OPS)
def test_op_matches_reference(mesh, op, agg, attack):
    jp, tp = protocols(agg, attack, embedding_robust=op == "plookup_robust")
    (jout, jgrads), (tout, tgrads) = _run_op(mesh, op, jp, tp)
    close(tout, jout, what=f"{op} forward")
    for i, (g, want) in enumerate(zip(tgrads, jgrads)):
        close(g, want, what=f"{op} gradient {i} under {agg}/{attack}")


@pytest.mark.parametrize("server", SERVERS)
@pytest.mark.parametrize("agg", AGGS)
def test_pmm_both_servers(mesh, agg, server):
    """Both server settings, on a weight whose fsdp dim splits: in one
    process both aggregate all N rows in place."""
    jp, tp = protocols(agg, "sign_flip", server=server)
    (jout, jgrads), (tout, tgrads) = _run_op(mesh, "pmm", jp, tp)
    for g, want in zip(tgrads, jgrads):
        close(g, want, what=f"pmm under {agg}/{server}")


@pytest.mark.parametrize("attack", ["alie", "ipm"])
def test_honest_statistics_with_no_honest_block(mesh, attack):
    """Every block Byzantine: the honest mean and variance divide by
    ``max(#honest, 1)`` (the reference's ``src/repro/core/protomath.py:174``),
    in the attack's plain version and its kernel alike (``csrc/attack.cu``:
    ``fmaxf(count, 1)``), so the rows become ``-z sqrt(1e-12)`` (ALIE) and
    ``0`` (IPM) on both sides."""
    jp, tp = protocols("mean", attack, n_byz=N)
    (_, jgrads), (_, tgrads) = _run_op(mesh, "pmm", jp, tp)
    close(tgrads[1], jgrads[1], atol_frac=0.0, what=attack)


def test_ops_outside_a_context_are_plain():
    """No context: each op is the plain op and builds no autograd Function."""
    rng = np.random.default_rng(3)
    x, w = (torch.tensor(a, requires_grad=True) for a in _op_inputs("pmm", rng))
    out = T.pmm("bsd,df->bsf", x, w)
    assert torch.equal(out, torch.einsum("bsd,df->bsf", x, w)) and "PMM" not in type(out.grad_fn).__name__
    table, ids = (torch.tensor(a) for a in _op_inputs("plookup_plain", rng))
    assert torch.equal(T.plookup(table, ids), table[ids])
    assert torch.equal(T.pscale(x, w[:, 0].reshape(6)[:6]), x * w[:, 0])
    tap, n = T.block_tap(w)
    assert n == 1 and torch.equal(tap, w[None])


def test_context_refusals():
    with pytest.raises(ValueError, match="model_size"):
        T.BlockedProtocol(model_size=0)
    with pytest.raises(ValueError, match="model group"):  # model_size=2 needs a model group of 2 ranks
        with T.protocol_context(T.BlockedProtocol(n_devices=4, model_size=2), 0):
            pass
    with pytest.raises(ValueError, match="server"):
        T.BlockedProtocol(server="ring")
    with pytest.raises(KeyError, match="mean/median/cwtm"):
        T._apply_rule(T.BlockedProtocol(n_devices=4, aggregator="krum"), torch.zeros((4, 3)))
    _, tp = protocols()
    x = torch.zeros((6, 5, 6), requires_grad=True)
    with T.protocol_context(tp, 0):
        out = T.pmm("bsd,df->bsf", x, torch.zeros((6, 7), requires_grad=True), w_spec=("fsdp", None))
    with pytest.raises(ValueError, match="device blocks"):
        out.sum().backward()


@pytest.mark.parametrize("family", ["mamba", "moe"])
def test_zoo_blocks_refuse_a_batch_that_does_not_split(family):
    """Under a context, Mamba's per-block A and MoE's per-block dispatch
    refuse a batch that does not split into the rank's device blocks (the
    reference falls back to one block there, and its A gradient then
    trims zero rows)."""
    from repro_torch.models import mamba, moe

    gen = torch.Generator().manual_seed(0)
    x = torch.zeros((6, 3, 8))  # 6 rows over N = 4 blocks
    _, tp = protocols()
    if family == "mamba":
        params, _ = mamba.mamba_init(gen, 8, 4, 4, 2, torch.float32)
        run = lambda: mamba.mamba(params, x, 4)  # noqa: E731
    else:
        params, _ = moe.moe_init(gen, 8, 16, 4, torch.float32)
        run = lambda: moe.moe(params, x, top_k=2)  # noqa: E731
    run()  # outside a context the batch is one block
    with T.protocol_context(tp, 0), pytest.raises(ValueError, match="device blocks"):
        run()


@pytest.mark.parametrize("family", ["mamba", "moe"])
def test_reference_blocks_fall_back_on_a_batch_that_does_not_split(mesh, family):
    """ROADMAP C.11: under ``BlockedProtocol(n_devices=4)`` a batch of 6
    rows does not split into the device blocks, and the reference neither
    splits it nor raises (``src/repro/models/mamba.py:96-97``,
    ``moe.py:55-56``). Mamba keeps block 0's A for every row: with each
    block's A made distinct, the 6-row forward equals the forward with no
    protocol (block 0's A is the parameter), while an 8-row batch reads
    each block's own. MoE routes the 6 rows as one block: with its
    capacity binding, the forward equals the one-block forward with no
    protocol, while 8 rows route per block. The port refuses such a batch
    (``test_zoo_blocks_refuse_a_batch_that_does_not_split``)."""
    from repro.models import mamba as jmamba
    from repro.models import moe as jmoe

    jp, _ = protocols("cwtm", "none", n_byz=0)
    rng = np.random.default_rng(11)
    if family == "mamba":
        params, _ = jmamba.mamba_init(jax.random.PRNGKey(0), 8, 4, 4, 2, jnp.float32)
        real = jmamba.block_tap

        def distinct(w):  # block i's A is (i + 1) x the parameter
            wb, n = real(w)
            return wb * (1.0 + jnp.arange(n, dtype=wb.dtype)).reshape((n,) + (1,) * w.ndim), n

        run = lambda x: jmamba.mamba(params, x, 4)  # noqa: E731
    else:
        params, _ = jmoe.moe_init(jax.random.PRNGKey(1), 8, 16, 4, jnp.float32)
        run = lambda x: jmoe.moe(params, x, top_k=2, capacity_factor=0.5)[0]  # noqa: E731
    same = {}
    for rows in (6, 8):
        x = jnp.asarray(rng.standard_normal((rows, 3, 8)).astype(np.float32))
        with mesh:
            alone = run(x)
            if family == "mamba":
                jmamba.block_tap = distinct
            try:
                with J.protocol_context(jp, jax.random.PRNGKey(0)):
                    blocked = run(x)
            finally:
                if family == "mamba":
                    jmamba.block_tap = real
        same[rows] = np.array_equal(np.asarray(blocked), np.asarray(alone))
    assert same == {6: True, 8: False}


def test_shared_sites_rewind_each_pass():
    """A loop body's passes take the same sites; after the loop the
    counter stands past the body's, and a later op takes the next site."""
    _, tp = protocols()
    w = torch.zeros((6,), requires_grad=True)
    x = torch.zeros((8, 6))
    with T.protocol_context(tp, 0):
        ctx = T.current_protocol()
        T.pscale(x, w)
        seen = []
        sites = T.shared_sites()
        for _ in range(3):
            with sites:
                seen.append(ctx.site)
                T.pscale(x, w)
                T.pbias(x, w)
        assert seen == [1, 1, 1] and ctx.site == 3
    assert T.current_protocol() is None


# ------------------------------------------------------------ whole models


MODELS = ["reduced-smollm-360m"] + [f"zoo-{f}" for f in jscn.ZOO_FAMILIES]


def _arch_pair(name):
    if name.startswith("zoo-"):
        return jscn.zoo_arch(name[4:]), tscn.zoo_arch(name[4:])
    return jreduced(JARCHS["smollm-360m"]), treduced(TARCHS["smollm-360m"])


def _model_batch(cfg, rng, rows=8, seq=16):
    b = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        b["frontend"] = rng.standard_normal((rows, cfg.encoder.n_frontend_tokens, cfg.encoder.d_frontend)).astype(
            np.float32)
    return b


def _model_grads(mesh, name, jp, tp, plain=False):
    """(reference, port) gradient trees of the loss, under the protocol
    (or with no context when ``plain``), on the reference's PRNGKey(0)
    parameters widened to float32."""
    jarch, tarch = _arch_pair(name)
    params, specs = jmodels.init(jax.random.PRNGKey(0), jarch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = _model_batch(jarch, np.random.default_rng(5))

    def jloss(pp):
        if plain:
            return jmodels.loss_fn(pp, specs, jarch, batch, remat=False)[0]
        with J.protocol_context(jp, jax.random.PRNGKey(0)):
            return jmodels.loss_fn(pp, specs, jarch, batch, remat=False)[0]

    with mesh:
        jg = jax.jit(jax.grad(jloss))(params)
    tparams = pytree.map_tree(lambda a: a.requires_grad_(), convert.lm_params_from_numpy(jax.tree.map(np.asarray,
                                                                                                      params)))
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    if plain:
        loss, _ = models.loss_fn(tparams, None, tarch, tbatch)
    else:
        with T.protocol_context(tp, 0):
            loss, _ = models.loss_fn(tparams, None, tarch, tbatch)
    leaves = pytree.leaves(tparams)
    grads = torch.autograd.grad(loss, leaves)
    return jax.tree.leaves(jg), list(grads), [k for k, _ in pytree.paths(tparams)]


@pytest.mark.parametrize("name", MODELS)
def test_whole_model_gradient_matches_reference(mesh, name):
    """CWTM (trim 1 of 4) under ALIE with one Byzantine block, every leaf."""
    jp, tp = protocols("cwtm", "alie")
    jg, tg, paths = _model_grads(mesh, name, jp, tp)
    assert len(jg) == len(tg)
    for path, got, want in zip(paths, tg, jg):
        close(got, want, atol_frac=GRAD_ATOL_FRAC, what=f"{name}: {path}")


def test_whole_model_nnm_and_robust_embedding(mesh):
    """CWTM-NNM under sign-flip with the lookups exchanged too."""
    jp, tp = protocols("cwtm-nnm", "sign_flip", embedding_robust=True)
    jg, tg, paths = _model_grads(mesh, "reduced-smollm-360m", jp, tp)
    for path, got, want in zip(paths, tg, jg):
        close(got, want, atol_frac=GRAD_ATOL_FRAC, what=path)


def test_exchanged_gradients_are_a_block_mean_c8(mesh):
    """ROADMAP C.8: under the honest mean (protocol "none") every
    exchanged leaf is 1/N of the plain gradient of the same loss, in the
    reference and in the port; the tied embedding table, whose lookups are
    not exchanged (``embedding_robust=False``), mixes 1/N of its head
    gradient with the whole of its lookup gradient."""
    jp, tp = protocols("mean", "none", n_byz=0, honest_mean=True)
    jg, tg, paths = _model_grads(mesh, "reduced-smollm-360m", jp, tp)
    jplain, tplain, _ = _model_grads(mesh, "reduced-smollm-360m", jp, tp, plain=True)
    for path, got, want, gp, wp in zip(paths, tg, jg, tplain, jplain):
        close(got, want, atol_frac=GRAD_ATOL_FRAC, what=path)
        if path != "embed/table":
            close(got, np.asarray(wp) / N, atol_frac=GRAD_ATOL_FRAC, what=f"{path}: 1/N of the plain gradient")
            close(got, gp.detach().numpy() / N, atol_frac=GRAD_ATOL_FRAC, what=f"{path}: port 1/N")
    i = paths.index("embed/table")
    ratio = float(torch.linalg.vector_norm(tg[i]) / torch.linalg.vector_norm(tplain[i]))
    want_ratio = float(np.linalg.norm(np.asarray(jg[i])) / np.linalg.norm(np.asarray(jplain[i])))
    assert abs(ratio - want_ratio) < 1e-5 and abs(ratio - 1.0 / N) > 0.1, (ratio, want_ratio)
    assert not torch.allclose(tg[i], tplain[i], rtol=1e-3, atol=0.0)


# ------------------------------------------------------------ statistics


Q_STAT = 4096


def _rows(rng, n=N, q=Q_STAT):
    return rng.standard_normal((n, q)).astype(np.float32)


def _port_device_side(tp, rows, seed, site=0):
    return T._device_side(T._Site(tp, T.fold_seed(seed, site), None, 1, 0), torch.tensor(rows)).numpy()


def _ref_corrupt(jp, rows, key):
    return np.asarray(J._corrupt_rows(jp, jnp.asarray(rows), key))


def test_gaussian_changes_the_byzantine_rows_alone():
    """The first n_byz rows become std * N(0, 1) draws, the others keep
    their bits, in both; the noise's moments agree with the reference's."""
    jp, tp = protocols("cwtm", "gaussian", n_byz=2)
    rows = _rows(np.random.default_rng(0))
    got = _port_device_side(tp, rows, 1)
    want = _ref_corrupt(jp, rows, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(got[2:], rows[2:])
    np.testing.assert_array_equal(want[2:], rows[2:])
    std = tp.attack.std
    for noise in (got[:2], want[:2]):
        assert not np.any(noise == rows[:2])
        z = noise / std
        assert abs(float(z.mean())) < 5 / np.sqrt(z.size) and abs(float(z.std()) - 1.0) < 0.05
    assert not np.array_equal(got[0], got[1])  # each Byzantine row its own draw
    again = _port_device_side(tp, rows, 1)
    np.testing.assert_array_equal(got, again)  # a function of (seed, site, row)
    assert not np.array_equal(got[:2], _port_device_side(tp, rows, 1, site=1)[:2])


COMPRESSORS = (("rand_sparse", dict(q_hat_frac=0.25)), ("rand_sparse_shared", dict(q_hat_frac=0.25)),
               ("quant", dict(levels=4, chunk=1024)))


@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=[c[0] for c in COMPRESSORS])
def test_compressors_support_and_unbiased(name, kw):
    """Each row keeps q_hat coordinates (one support for every row with
    the shared mask), and over 400 draws the mean of the compressed rows is
    the rows within 5 standard errors of a coordinate's largest standard
    deviation (``|g|max sqrt(Q/q_hat - 1)`` sparsified, half a QSGD level
    quantized), on both sides."""
    jp, tp = protocols("mean", "none", n_byz=0, compression=dict(name=name, **kw))
    rows = _rows(np.random.default_rng(1), q=512)
    draws = 400
    top = np.abs(rows).max(axis=1, keepdims=True)
    sigma = top * (0.5 / kw["levels"] if name == "quant" else np.sqrt(1.0 / kw["q_hat_frac"] - 1.0))
    port = np.stack([_port_device_side(tp, rows, s) for s in range(draws)])
    keys = jax.random.split(jax.random.PRNGKey(2), draws)
    ref = np.asarray(jax.jit(jax.vmap(lambda k: J._corrupt_rows(jp, jnp.asarray(rows), k)))(keys))
    for what, got in (("port", port), ("reference", ref)):
        if name != "quant":
            kept = (got != 0).sum(axis=-1)
            assert (kept == tcomp.CompressionSpec(name=name, **kw).kept(512)).all(), what
            if name == "rand_sparse_shared":
                assert ((got[:, 0] != 0) == (got[:, 1] != 0)).all(), what
            else:
                assert ((got[:, 0] != 0) != (got[:, 1] != 0)).any(), what
        assert (np.abs(got.mean(axis=0) - rows) < 5 * sigma / np.sqrt(draws)).all(), what
    np.testing.assert_allclose(port.std(axis=0).mean(), ref.std(axis=0).mean(), rtol=0.05)


def test_compressed_exchange_is_unbiased_through_the_mean():
    """Through ``robust_combine`` with the mean: over draws, the aggregate
    of rand_sparse rows averages to the rows' mean."""
    _, tp = protocols("mean", "none", n_byz=0, compression=dict(name="rand_sparse", q_hat_frac=0.5))
    rows = torch.tensor(_rows(np.random.default_rng(4), q=256))
    aggs = torch.stack([T.robust_combine(tp, rows, seed=s) for s in range(400)])
    se = aggs.std(dim=0) / 20 + 1e-7
    assert ((aggs.mean(dim=0) - rows.mean(dim=0)).abs() < 5 * se).float().mean() > 0.995


def test_dataclass_fields_match_reference():
    """``BlockedProtocol`` keeps the reference's fields."""
    assert [f.name for f in dataclasses.fields(T.BlockedProtocol)] == \
        [f.name for f in dataclasses.fields(J.BlockedProtocol)]
