from repro_torch.checkpoint.checkpoint import load_checkpoint, restore_for_serving, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "restore_for_serving"]
