"""Headless interactive-editing demo (``python -m michigan_tpu_torch.demo``)."""
