"""Train-state checkpoints on torch.save, with resume and best-metric tracking."""
