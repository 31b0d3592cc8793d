"""The interactive-editing demo: the edit engine, the Qt editor and the
headless edit (``python -m michigan_tpu_torch.demo``)."""
