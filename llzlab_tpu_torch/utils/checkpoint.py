"""Streaming-state checkpoint/resume (port of
``llzlab_tpu/utils/checkpoint.py``).

The file format is the JAX package's: an ``.npz`` with one array per state
leaf (``leaf_0``, ``leaf_1``, …, in depth-first order, ``None`` leaves
skipped as JAX skips them) and a JSON ``__meta__`` record (block index,
config hash, leaf count).  So a checkpoint written by a JAX chain resumes
in the port, and the reverse.

Chain state in the port is a tuple of tensors (one per stage, ``None`` for
a stateless stage), possibly nested in tuples, lists or dicts; a
channelizer's state is the pair ``(fir_state, rs_state)``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["save_state", "load_state", "from_reference"]


def _leaves(state) -> List[Any]:
    """Depth-first leaves, skipping None (dict keys in sorted order, as
    jax.tree.flatten orders them)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _leaves(s)]
    if isinstance(state, dict):
        return [leaf for key in sorted(state) for leaf in _leaves(state[key])]
    return [state]


def _unflatten(like, leaves: List[torch.Tensor]):
    """Fill ``like``'s structure with ``leaves`` (consumed from the front)."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(s, leaves) for s in like)
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return leaves.pop(0)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(
    path: str,
    state,
    *,
    block_index: int,
    config_hash: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Dump a streaming state + stream position to ``path`` (.npz)."""
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    meta = {
        "block_index": int(block_index),
        "config_hash": config_hash,
        "treedef": f"torch-state({len(leaves)} leaves)",
        "n_leaves": len(leaves),
        "extra": extra or {},
    }
    np.savez(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    ), **arrays)


def load_state(path: str, like=None, *, device="cpu"):
    """Load ``(state, block_index, meta)``.

    ``like``: an example state (e.g. ``chain.init_state(..., device=...)``)
    whose structure is filled positionally; each leaf goes to the device of
    the leaf it replaces.  Without it, the flat list of leaves is returned
    as tensors on ``device``.
    """
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if like is None:
        return [torch.from_numpy(a).to(device) for a in arrays], \
            meta["block_index"], meta
    ex = _leaves(like)
    if len(ex) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template has {len(ex)}")
    for a, e in zip(arrays, ex):
        if tuple(a.shape) != tuple(e.shape):
            raise ValueError(
                f"checkpoint leaf shape {a.shape} != template {tuple(e.shape)}")
    leaves = [torch.from_numpy(a).to(device=e.device, dtype=e.dtype)
              for a, e in zip(arrays, ex)]
    return _unflatten(like, leaves), meta["block_index"], meta


def from_reference(state, device):
    """A JAX streaming state, handed over as numpy arrays, as the port's
    state on ``device``: a chain's tuple (``None`` for stateless stages,
    a dict for ``SpectralGainStage``, whose 0-dim int32 ``pos`` keeps its
    dtype), or a channelizer's ``(fir_state, rs_state)`` pair, whose second
    leaf is the ``(C, 0)`` placeholder with the fused engine.  The
    structure is kept."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(from_reference(s, device) for s in state)
    if isinstance(state, dict):
        return {key: from_reference(v, device) for key, v in state.items()}
    return torch.from_numpy(np.array(state)).to(device)
