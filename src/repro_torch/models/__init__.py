"""The transformer LM of every family (dense, MoE, the Mamba hybrid,
RWKV-6, cross-attention and the whisper encoder-decoder), in plain
PyTorch, and its serving path (prefill and cached decode)."""
from repro_torch.models import attention, layers, mamba, module, moe, precision, rwkv, serving, transformer
from repro_torch.models.serving import decode_step, init_decode_state, prefill
from repro_torch.models.transformer import forward, init, loss_fn

__all__ = ["attention", "layers", "mamba", "module", "moe", "precision", "rwkv", "serving", "transformer", "forward",
           "init", "loss_fn", "init_decode_state", "prefill", "decode_step"]
