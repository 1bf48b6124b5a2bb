"""Diagnostic entry points on the card: ``python -m eigd_tpu_torch.diag.<name>``."""
