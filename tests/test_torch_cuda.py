"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  This file imports no
JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from llzlab_tpu_torch.ops.fir import block2_block, firwin
from llzlab_tpu_torch.ops.resample import resample_taps

NTAPS, UP, DOWN, K = 129, 3, 4, 8
#: kernel vs its plain version run in float64 (the floors of chip_smoke.py):
#: f32 sum order at "highest", the bf16x3 error at "high"
FLOOR_DB = {"highest": 130.0, "high": 75.0}


def _snr_db(ref, y):
    ref = ref.double().cpu().numpy()
    err = ref - y.double().cpu().numpy()
    return 10.0 * np.log10(np.sum(ref * ref) / np.sum(err * err))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "highest"])
def test_kernels_match_plain_versions(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(41)
    taps = firwin(NTAPS, 0.2)
    rtaps = resample_taps(UP, DOWN, K)
    block = block2_block(NTAPS)
    t = 3 * ff.fused_program_in(NTAPS, UP, DOWN)
    x = torch.from_numpy(rng.standard_normal((8, t)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal(
        (8, 2 * block)).astype(np.float32))
    x, hist = x.cuda(), hist.cuda()
    xpad = torch.cat([hist[:, :block], x], -1).contiguous()

    n = bf.block2_fir_cuda.launches
    y = bf.block2_fir(xpad, taps, block, mode=mode)
    assert bf.block2_fir_cuda.launches == n + 1
    ref = bf.block2_fir_plain(xpad.double(), taps, block, "highest")
    assert _snr_db(ref, y) >= FLOOR_DB[mode]

    n = ff.fused_fir_resample_cuda.launches
    z = ff.fused_fir_resample(x, taps, UP, DOWN, rtaps, zi=hist, mode=mode)
    assert ff.fused_fir_resample_cuda.launches == n + 1
    ref = ff.fused_fir_resample_plain(x.double(), hist.double(), taps, UP,
                                      DOWN, rtaps, "highest")
    assert z.shape == ref.shape
    assert _snr_db(ref, z) >= FLOOR_DB[mode]
