"""Multi-process runs on torch.distributed (distributed) and the cards of
one host (mesh)."""
