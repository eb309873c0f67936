"""Kernel B1's plain version (the port's fused FIR→resample op on a CPU
tensor) against the JAX package: its Pallas kernel in interpret mode, its
unfused op chain and scipy float64."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

from llzlab_tpu.kernels import fused_fir_resample as rff
from llzlab_tpu.ops import fir as rfir
from llzlab_tpu.ops import resample as rrs
from llzlab_tpu_torch.kernels import fused_fir_resample as ff
from tests.conftest import snr_db

NTAPS, UP, DOWN, K = 129, 3, 4, 8
MODES = ["high", "highest"]
#: the floors of the JAX package's own fused-vs-unfused test
#: (tests/kernels/test_fused_fir_resample.py): f32 sum order at "highest",
#: the bf16x3 error at "high" where one side runs plain f32
VS_REF_DB = {"highest": 130.0, "high": 75.0}
#: port plain vs the JAX kernel at "high": both form the same bf16x3
#: products from the same hi/lo splits, only the f32 sum order differs
#: (measured 124-127 dB)
VS_KERNEL_HIGH_DB = 110.0
VS_SCIPY_DB = {"highest": 110.0, "high": 80.0}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    taps = rfir.firwin(NTAPS, 0.2, window="hamming")
    rtaps = rrs.resample_taps(UP, DOWN, K)
    p = rff.fused_program_in(NTAPS, UP, DOWN)
    x = rng.standard_normal((8, 2 * p)).astype(np.float32)
    zi = rng.standard_normal((8, rff.fused_state_len(NTAPS))).astype(
        np.float32)
    ref = {mode: rff.fused_fir_resample_pallas(
        jnp.asarray(x), taps, UP, DOWN, rtaps, zi=jnp.asarray(zi),
        return_zf=True, mode=mode, interpret=True) for mode in MODES}
    return dict(taps=taps, rtaps=rtaps, p=p, x=x, zi=zi, ref=ref)


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_kernel_with_history(case, mode):
    z, zf = ff.fused_fir_resample(
        torch.from_numpy(case["x"]), case["taps"], UP, DOWN, case["rtaps"],
        zi=torch.from_numpy(case["zi"]), return_zf=True, mode=mode)
    z_ref, zf_ref = case["ref"][mode]
    assert z.shape == z_ref.shape and z.dtype == torch.float32
    floor = VS_REF_DB[mode] if mode == "highest" else VS_KERNEL_HIGH_DB
    assert snr_db(np.asarray(z_ref, np.float64), z.numpy()) >= floor
    np.testing.assert_array_equal(zf.numpy(), np.asarray(zf_ref))


@pytest.mark.parametrize("mode", MODES)
def test_matches_reference_unfused_chain_and_scipy(case, mode):
    x, taps, rtaps = case["x"], case["taps"], case["rtaps"]
    z = ff.fused_fir_resample(torch.from_numpy(x), taps, UP, DOWN, rtaps,
                              mode=mode).numpy()
    y = rfir.fir_filter(jnp.asarray(x), taps, method="block2")
    z_ref = np.asarray(rrs.resample_poly(y, UP, DOWN, taps=rtaps))
    assert z.shape == z_ref.shape
    assert snr_db(z_ref.astype(np.float64), z) >= VS_REF_DB[mode]
    y64 = ss.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    z64 = ss.upfirdn(rtaps, y64, UP, DOWN, axis=-1)[:, : z.shape[-1]]
    for c in range(x.shape[0]):
        assert snr_db(z64[c], z[c]) >= VS_SCIPY_DB[mode]


@pytest.mark.parametrize("mode", MODES)
def test_split_at_program_boundary_bit_exact(case, mode):
    x = torch.from_numpy(case["x"])
    zi = torch.from_numpy(case["zi"])
    args = (case["taps"], UP, DOWN, case["rtaps"])
    p = case["p"]
    full = ff.fused_fir_resample(x, *args, zi=zi, mode=mode)
    za, zf = ff.fused_fir_resample(x[:, :p], *args, zi=zi, return_zf=True,
                                   mode=mode)
    zb = ff.fused_fir_resample(x[:, p:], *args, zi=zf, mode=mode)
    torch.testing.assert_close(torch.cat([za, zb], -1), full, rtol=0, atol=0)


def test_envelope_enforced_on_cpu_and_kernel_wrapper_needs_cuda(case):
    x = torch.from_numpy(case["x"])
    args = (case["taps"], UP, DOWN, case["rtaps"])
    with pytest.raises(ValueError, match="channels % 8"):
        ff.fused_fir_resample(x[:5], *args)
    with pytest.raises(ValueError, match="multiple of"):
        ff.fused_fir_resample(x[:, : case["p"] + DOWN], *args)
    hist = torch.zeros(8, ff.fused_state_len(NTAPS))
    before = ff.fused_fir_resample_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ff.fused_fir_resample_cuda(x, hist, *args)
    assert ff.fused_fir_resample_cuda.launches == before


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_kernel_v4_body(case, mode):
    """``_kernel_v4`` is an alternate body behind the same ``pallas_call``
    as ``_kernel`` (v3) and computes the same function, so kernel B1 is its
    counterpart too: the port's plain version holds against it at the
    floors it holds against v3."""
    z, zf = ff.fused_fir_resample(
        torch.from_numpy(case["x"]), case["taps"], UP, DOWN, case["rtaps"],
        zi=torch.from_numpy(case["zi"]), return_zf=True, mode=mode)
    z_ref, zf_ref = rff.fused_fir_resample_pallas(
        jnp.asarray(case["x"]), case["taps"], UP, DOWN, case["rtaps"],
        zi=jnp.asarray(case["zi"]), return_zf=True, mode=mode,
        interpret=True, impl="v4", nw=1)
    floor = VS_REF_DB[mode] if mode == "highest" else VS_KERNEL_HIGH_DB
    assert snr_db(np.asarray(z_ref, np.float64), z.numpy()) >= floor
    np.testing.assert_array_equal(zf.numpy(), np.asarray(zf_ref))
