"""Serving steps (prefill, decode) and one batch of greedy traffic.

Inference carries no gradient exchange, so the LAD protocol is inactive
here: the paper's technique is train-time. The serving path is the model
substrate under the prefill and decode input shapes.

``serve_traffic`` prefills a prompt and decodes greedily, in one of two
modes that give the same tokens and state bit for bit:

  * ``"graph"`` (CUDA only; the reference's ``jax.jit``): one decode step
    and its ``argmax`` captured as a CUDA graph over static buffers (the
    token, the decode state, the output tokens and the step's column) and
    replayed once a token;
  * ``"loop"``: the same step, eager.

Nothing is read back to the host until the last step has run.

The mesh pspecs of the decode state and of the serve inputs split the
caches over the ``model`` axis as well as the data axis: they wait for the
model axis and sharded storage (ROADMAP A.9c).
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import _check_mode
from repro_torch.device import resolve_device
from repro_torch.models import serving

__all__ = ["build_prefill_fn", "build_decode_fn", "GreedyDecoder", "serve_traffic", "decode_state_pspecs",
           "serve_input_specs"]


def build_prefill_fn(cfg: ArchConfig, specs: Any, *, capacity: int | None = None) -> Callable:
    """``(params, tokens, frontend=None) -> (logits, state)``; ``capacity``
    reserves ring headroom so decode can run past the prompt without
    evicting position 0."""

    def fn(params, tokens, frontend=None):
        return serving.prefill(params, specs, cfg, tokens, frontend=frontend, capacity=capacity)

    return fn


def build_decode_fn(cfg: ArchConfig, specs: Any) -> Callable:
    """``(params, token, state) -> (logits, state)``, the caches written in
    place (``models.serving``)."""

    def fn(params, token, state):
        return serving.decode_step(params, specs, cfg, token, state)

    return fn


def decode_state_pspecs(state_shapes: Any, mesh: Any) -> Any:
    raise ValueError("the decode state's mesh pspecs wait for the model axis and sharded storage (ROADMAP A.9c)")


def serve_input_specs(cfg: ArchConfig, shape: Any, mesh: Any) -> Any:
    raise ValueError("the serve inputs' mesh specs wait for the model axis and sharded storage (ROADMAP A.9c)")


def _small_leaves(state: dict) -> dict[str, torch.Tensor]:
    """Every leaf of a decode state but the caches' K/V buffers, by path."""
    return {k: v for k, v in pytree.paths(state) if not k.endswith(("/.k", "/.v"))}


class GreedyDecoder:
    """Greedy decode over static buffers: the token, the decode state, the
    ``(B, new_tokens)`` output and the step's column; ``__call__`` runs one
    step (in graph mode a replay of its capture). A step decodes, writes
    the new small leaves of the state into its buffers (the caches' K/V are
    written in place by the step itself), takes the ``argmax`` and writes
    it as the next token and into the output's column.

    The first step runs once untimed (on a side stream in graph mode, before
    the capture) and is then undone: the state's small leaves, the token
    and the column are restored. The K/V it wrote is the slot the first real
    step writes again, with the same values, before it reads it. A call
    past ``new_tokens`` raises: its column would lie outside the output."""

    def __init__(self, decode_fn: Callable, params, tok: torch.Tensor, state: dict, new_tokens: int, mode: str):
        self.decode_fn, self.params = decode_fn, params
        dev = tok.device
        self.bufs = {"tok": tok.clone(), "state": state, "t": torch.zeros((), dtype=torch.int64, device=dev),
                     "out": torch.zeros((tok.shape[0], new_tokens), dtype=torch.int32, device=dev)}
        saved = {k: v.clone() for k, v in _small_leaves(state).items()}
        self.graph, self.calls, self.new_tokens = None, 0, new_tokens
        if mode == "graph":
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            self._step()
        self._restore(saved, tok)
        if mode == "graph":
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._step()

    def _restore(self, saved: dict, tok: torch.Tensor) -> None:
        for k, v in _small_leaves(self.bufs["state"]).items():
            v.copy_(saved[k])
        self.bufs["tok"].copy_(tok)
        self.bufs["t"].zero_()

    def _step(self) -> None:
        b = self.bufs
        logits, new = self.decode_fn(self.params, b["tok"], b["state"])
        new = _small_leaves(new)
        for k, v in _small_leaves(b["state"]).items():
            v.copy_(new[k])
        # torch.argmax returns the first maximal index, as jnp.argmax does
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        b["tok"].copy_(nxt)
        b["out"].index_copy_(1, b["t"].reshape(1), nxt)
        b["t"].add_(1)

    def __call__(self) -> None:
        if self.calls == self.new_tokens:  # the output's columns are full: a step past them writes out of bounds
            raise ValueError(f"the decoder's {self.new_tokens} tokens are all decoded")
        self.calls += 1
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()


class _Clock:
    """Seconds of a stretch of work: by CUDA events on a card (``card_s``)
    and on the host clock up to a synchronize (``host_s``)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.dev = dev

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.events[1].record()
            torch.cuda.synchronize(self.dev)
        self.host_s = time.perf_counter() - self.t0
        self.card_s = self.events[0].elapsed_time(self.events[1]) / 1e3 if self.cuda else None
        return False


def serve_traffic(cfg: ArchConfig, params, specs, tokens: torch.Tensor, *, frontend: torch.Tensor | None = None,
                  new_tokens: int = 8, mode: str = "graph", device: torch.device | str | None = None) -> dict:
    """Serve one batch: prefill the prompt ``tokens`` (B, s), then decode
    ``new_tokens`` tokens greedily (capacity ``s + new_tokens``). Each of
    prefill and decode runs once untimed first, as the reference compiles
    first.

    Returns the reference's ``prefill_s``, ``decode_s``,
    ``prefill_tokens_per_s``, ``decode_tokens_per_s``, ``tokens`` (B,
    new_tokens) int32 and ``pos``, plus ``prefill_host_s``/``decode_host_s``
    and the final decode ``state``. On a card the seconds are the card's (CUDA
    events) with the host's beside them; on the CPU both are the host's
    (``clock`` says which)."""
    dev = resolve_device(device)
    _check_mode(mode, dev)
    params = pytree.map_tree(lambda a: a.to(dev), params)
    tokens = tokens.to(dev)
    frontend = None if frontend is None else frontend.to(dev)
    b, s = tokens.shape
    prefill_fn = build_prefill_fn(cfg, specs, capacity=s + new_tokens)
    prefill_fn(params, tokens, frontend)  # untimed first call
    with _Clock(dev) as pre:
        logits, state = prefill_fn(params, tokens, frontend)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    greedy = GreedyDecoder(build_decode_fn(cfg, specs), params, tok, state, new_tokens, mode)
    with _Clock(dev) as dec:
        for _ in range(new_tokens):
            greedy()
    prefill_s = pre.host_s if pre.card_s is None else pre.card_s
    decode_s = dec.host_s if dec.card_s is None else dec.card_s
    return {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "prefill_tokens_per_s": b * s / max(prefill_s, 1e-9),
        "decode_tokens_per_s": b * new_tokens / max(decode_s, 1e-9),
        "tokens": greedy.bufs["out"],
        "pos": int(greedy.bufs["state"]["pos"]),
        "prefill_host_s": pre.host_s,
        "decode_host_s": dec.host_s,
        "clock": "cuda_events" if pre.card_s is not None else "host",
        "state": greedy.bufs["state"],
    }
