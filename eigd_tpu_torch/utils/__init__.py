"""Checkpoints, profiling and plots (counterpart of ``eigd_tpu/utils``)."""
