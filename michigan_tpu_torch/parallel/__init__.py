"""Data-parallel training over torch.distributed, one process per device
(the port's counterpart of michigan_tpu/parallel)."""
