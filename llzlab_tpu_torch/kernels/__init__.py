"""Hand-written CUDA kernels for Hopper, one module each.

Each module holds the kernel's wrapper (with a launch count), its plain
PyTorch version (the CPU path and the kernel's oracle) and its tables; the
sources live in ``llzlab_tpu_torch/csrc`` and are built at first use.
"""
