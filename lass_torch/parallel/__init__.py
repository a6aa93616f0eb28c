"""Data parallelism over several cards, one process per card, and tensor
parallelism over a grid's model axis (counterpart of lass_tpu/parallel)."""
