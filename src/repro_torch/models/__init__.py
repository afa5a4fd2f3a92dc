"""The transformer LM (the dense family), in plain PyTorch."""
from repro_torch.models import attention, layers, module, transformer
from repro_torch.models.transformer import forward, init, loss_fn

__all__ = ["attention", "layers", "module", "transformer", "forward", "init", "loss_fn"]
