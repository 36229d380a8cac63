from repro_torch.checkpoint.io import save_checkpoint, restore_checkpoint  # noqa: F401
