"""Batched serving over the PyTorch port: prefill a batch of prompts, then
stream decode steps.

Uses the reduced RWKV-6 config (O(1) state, the long-context family), a
reduced llama-family model and the reduced whisper encoder-decoder side by
side, through the shared serving API (prefill -> ring-buffer/state caches
-> decode_step).

    PYTHONPATH=src python examples/torch_serve_decode.py
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse

import torch

from repro_torch import models, pytree
from repro_torch.configs.archs import ARCHS, reduced
from repro_torch.device import resolve_device


@torch.no_grad()
def serve(arch: str, dev: torch.device, prompt_len: int = 48, new_tokens: int = 16, batch: int = 4):
    cfg = reduced(ARCHS[arch])
    params, specs = models.init(torch.Generator().manual_seed(0), cfg)
    params = pytree.map_tree(lambda a: a.to(dev), params)

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, dtype=torch.int32).to(dev)
    frontend = None
    if cfg.family in ("vlm", "audio"):
        enc = cfg.encoder
        frontend = torch.randn((batch, enc.n_frontend_tokens, enc.d_frontend), generator=gen).to(dev)

    logits, state = models.prefill(params, specs, cfg, prompts, frontend=frontend,
                                   capacity=prompt_len + new_tokens)
    token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    generated = [token]
    for _ in range(new_tokens - 1):
        logits, state = models.decode_step(params, specs, cfg, token, state)
        token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        generated.append(token)
    out = torch.cat(generated, dim=1)
    assert out.shape == (batch, new_tokens)
    assert not bool(torch.isnan(logits).any())
    print(f"{arch:24s} served {batch} seqs x {new_tokens} tokens; "
          f"first row: {out[0, :8].tolist()} ...")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prompt-len", type=int, default=48)
    parser.add_argument("--new-tokens", type=int, default=16)
    args = parser.parse_args()
    dev = resolve_device(args.device)
    for arch in ["smollm-360m", "rwkv6-1.6b", "whisper-small"]:
        serve(arch, dev, prompt_len=args.prompt_len, new_tokens=args.new_tokens)
    print("OK: greedy batched decoding ran for dense, SSM and enc-dec families.")


if __name__ == "__main__":
    main()
