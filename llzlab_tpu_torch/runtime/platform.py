"""Device and precision policy of the port.

Counterpart of ``llzlab_tpu/runtime/platform.py`` (device bootstrap) and
``llzlab_tpu/ops/transform.py:matmul_precision_name`` (precision names).

* The port never picks a device in silence: callers name it, and
  :func:`require_cuda` raises where a GPU is needed and missing.
* Precision names are those of the JAX package, read from
  ``LLZ_MATMUL_PRECISION`` (default ``highest``).  The kernels take
  ``"highest"`` (fp32) or ``"high"`` (explicit bf16x3); ``"default"``
  maps to ``"high"``, as in the JAX package's kernel dispatch.
* A ``highest`` result must never pass through TF32, so both of PyTorch's
  TF32 switches are pinned off when the port is imported (they default to
  on for cuDNN convolutions).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["require_cuda", "matmul_precision_name", "kernel_mode"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MODES = {"highest": "highest", "high": "high", "default": "high"}


def require_cuda() -> torch.device:
    """The current CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: the llzlab_tpu_torch kernels need an "
            "NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def matmul_precision_name() -> str:
    """Resolved precision name ("highest" | "high" | "default")."""
    name = os.environ.get("LLZ_MATMUL_PRECISION", "highest").lower()
    if name not in _MODES:
        raise ValueError(
            f"LLZ_MATMUL_PRECISION must be one of highest|high|default, "
            f"got {name!r}")
    return name


def kernel_mode(precision: Optional[str] = None) -> str:
    """Kernel precision mode for ``precision`` (None: the environment)."""
    name = matmul_precision_name() if precision is None else precision
    try:
        return _MODES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None
