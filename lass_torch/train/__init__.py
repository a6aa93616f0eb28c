"""Training: optimizer and schedules, checkpoints, the Trainer loop and
``python -m lass_torch.train``."""
