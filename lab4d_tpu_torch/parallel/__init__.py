"""Multi-process training (torch.distributed): see parallel/dist.py."""
