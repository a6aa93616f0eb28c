"""PyTorch port of lass_tpu for NVIDIA GPUs (see README, "PyTorch port")."""
