"""dcpt_tpu_torch: the PyTorch/CUDA port of dcpt_tpu for NVIDIA Hopper.

Mirrors ``dcpt_tpu``'s module paths.  Plain tensor code is PyTorch; the
kernels that ``dcpt_tpu`` wrote in Pallas for the TPU are hand-written CUDA
under ``csrc/``, built with nvcc at first use.  Importing this package loads
nothing else: subpackages are imported where they are used.
"""
