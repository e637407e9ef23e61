"""repro_torch: the PyTorch/CUDA port of `repro`, for one NVIDIA H100.

The package imports torch and numpy and nothing of JAX or of `repro`; what it
needs of the JAX package (configs, flags) it keeps as its own copy.  Its
TPU kernels are rewritten by hand for Hopper under `csrc/`, built with nvcc
at first use (`kernels/_build.py`).  Entry points default to
`device="cuda"`; CPU tensors take each kernel's plain PyTorch version.
"""
