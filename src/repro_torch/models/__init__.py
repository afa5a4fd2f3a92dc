"""The transformer LM of every family (dense, MoE, the Mamba hybrid,
RWKV-6, cross-attention and the whisper encoder-decoder), in plain
PyTorch."""
from repro_torch.models import attention, layers, mamba, module, moe, precision, rwkv, transformer
from repro_torch.models.transformer import forward, init, loss_fn

__all__ = ["attention", "layers", "mamba", "module", "moe", "precision", "rwkv", "transformer", "forward", "init",
           "loss_fn"]
