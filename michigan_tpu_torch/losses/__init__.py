"""The training losses (port of michigan_tpu/losses, reference loss.py) as
functions on NCHW tensors."""
