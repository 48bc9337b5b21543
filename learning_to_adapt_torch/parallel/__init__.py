"""Data parallelism over ranks of torch.distributed (parallel/)."""
