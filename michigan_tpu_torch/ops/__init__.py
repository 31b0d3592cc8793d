"""Numerics of the port: plain torch ops (NCHW) and, under ``cuda``, the
hand-written kernels."""
