"""A CPU emulation of the CUDA runtime, to run a csrc kernel where there is no GPU (see ``build``)."""
