from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint  # noqa: F401
