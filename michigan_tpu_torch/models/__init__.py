"""nn.Modules of the flagship inference path, NCHW.  Submodule names follow
the reference checkpoints' state_dict keys."""
