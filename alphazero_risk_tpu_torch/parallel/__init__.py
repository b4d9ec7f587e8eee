"""The multi-process world: one process per card over torch.distributed."""
