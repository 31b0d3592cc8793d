"""Data-parallel training (dist.py) and spatially sharded inference
(spatial.py) over torch.distributed, one process per device (the port's
counterpart of michigan_tpu/parallel)."""
