"""Data parallelism over several cards, one process per card
(counterpart of lass_tpu/parallel)."""
