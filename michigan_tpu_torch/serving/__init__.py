"""Serving (port of michigan_tpu/serving): the shape-bucketed session on CUDA
graphs and the exported inference program (``torch.export``)."""

from michigan_tpu_torch.serving.export import export_inference, load_exported
from michigan_tpu_torch.serving.session import InferenceSession

__all__ = ["export_inference", "load_exported", "InferenceSession"]
