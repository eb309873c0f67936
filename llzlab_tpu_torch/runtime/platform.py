"""Device and precision policy of the port.

Counterpart of ``llzlab_tpu/runtime/platform.py`` (device bootstrap) and
``llzlab_tpu/ops/transform.py:matmul_precision_name`` (precision names).

* The port never picks a device in silence: callers name it, and
  :func:`require_cuda` raises where a GPU is needed and missing.
* Precision names are those of the JAX package, read from a
  :func:`precision_scope` around the call, else from
  ``LLZ_MATMUL_PRECISION`` (default ``highest``).  The kernels take
  ``"highest"`` (fp32) or ``"high"`` (explicit bf16x3); ``"default"``
  maps to ``"high"``, as in the JAX package's kernel dispatch.  The name
  selects what the hand kernels compute, and nothing else: the port's
  plain ``torch.matmul`` products run fp32 with TF32 off at every name
  (the JAX package's ``high`` also lowers XLA's einsums to bf16x3).
* A ``highest`` result must never pass through TF32, so both of PyTorch's
  TF32 switches are pinned off when the port is imported (they default to
  on for cuDNN convolutions).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

import torch

__all__ = ["require_cuda", "matmul_precision_name", "kernel_mode",
           "precision_scope"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MODES = {"highest": "highest", "high": "high", "default": "high"}
#: the name a :func:`precision_scope` pins, per thread and task
_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "llz_matmul_precision", default=None)


def require_cuda() -> torch.device:
    """The current CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: the llzlab_tpu_torch kernels need an "
            "NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def matmul_precision_name() -> str:
    """Resolved precision name ("highest" | "high" | "default"): the
    innermost :func:`precision_scope`'s, else ``LLZ_MATMUL_PRECISION``'s."""
    name = (_OVERRIDE.get()
            or os.environ.get("LLZ_MATMUL_PRECISION", "highest")).lower()
    if name not in _MODES:
        raise ValueError(
            f"LLZ_MATMUL_PRECISION/precision_scope must be one of "
            f"highest|high|default, got {name!r}")
    return name


@contextlib.contextmanager
def precision_scope(name: Optional[str]):
    """Pin :func:`matmul_precision_name` (so :func:`kernel_mode`, which
    the kernel wrappers read) to ``name`` for the enclosed calls; ``None``
    inherits the environment's.  A stage with its own accuracy budget
    (``SpectralGainStage``) is so never degraded by a process-wide
    ``LLZ_MATMUL_PRECISION=high``.  The port runs eagerly, so the scope
    holds while the enclosed work is queued; plain ``torch.matmul``
    products are fp32 with TF32 off whatever the name."""
    if name is None:
        yield
        return
    if name.lower() not in _MODES:
        raise ValueError(f"precision_scope: unknown precision {name!r}")
    token = _OVERRIDE.set(name.lower())
    try:
        yield
    finally:
        _OVERRIDE.reset(token)


def kernel_mode(precision: Optional[str] = None) -> str:
    """Kernel precision mode for ``precision`` (None: the environment)."""
    name = matmul_precision_name() if precision is None else precision
    try:
        return _MODES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None
