"""Kernel B4's plain version on CPU meshes, against the JAX package's fused
halo + block2 FIR kernel (interpret mode under ``shard_map``, as its own
tests run it) and against the port's unsharded block2 FIR."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from llzlab_tpu.kernels import halo_fir_fused as rhf
from llzlab_tpu.parallel.mesh import TIME_AXIS as REF_TIME_AXIS
from llzlab_tpu_torch.kernels import block2_fir as bf
from llzlab_tpu_torch.kernels import halo_fir_fused as hf
from llzlab_tpu_torch.ops.fir import block2_block, firwin
from llzlab_tpu_torch.parallel import mesh as pmesh
from tests.conftest import snr_db

MODES = ["high", "highest"]
#: port plain vs the JAX kernel: the same bf16x3 (or f32) products, summed
#: in another f32 order (the floors of tests/test_torch_block2_fir.py)
VS_KERNEL_DB = {"highest": 130.0, "high": 120.0}
NTAPS, C = 256, 8
BLOCK = block2_block(NTAPS)
T_LOC = 2 * BLOCK


def _cpu_mesh(n):
    return pmesh.DspMesh(["cpu"] * n, (pmesh.TIME_AXIS,))


def _case(n, seed, h):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, n * T_LOC)).astype(np.float32)
    hist = (None if h is None
            else rng.standard_normal((C, h)).astype(np.float32))
    return firwin(NTAPS, 0.3), x, hist


def _port(x, taps, hist, n, mode):
    mesh = _cpu_mesh(n)
    parts = pmesh.shard_time(torch.from_numpy(x), mesh)
    before = hf.block2_fir_halo_fused_cuda.launches
    got = hf.block2_fir_halo_fused(
        parts, taps, mesh, mode=mode,
        first_shard_value=None if hist is None else torch.from_numpy(hist))
    assert hf.block2_fir_halo_fused_cuda.launches == before  # CPU: plain
    return pmesh.gather_time(got, mesh)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [2, 4])
def test_plain_matches_reference_kernel(n, mode):
    taps, x, hist = _case(n, 31, NTAPS - 1)
    mesh = Mesh(np.asarray(jax.devices()[:n]), (REF_TIME_AXIS,))
    f = jax.jit(jax.shard_map(
        lambda x_l, hs: rhf.block2_fir_halo_fused(
            x_l, taps, first_shard_value=hs, mode=mode, use_rdma=True,
            interpret=True),
        mesh=mesh, in_specs=(P(None, REF_TIME_AXIS), P(None, None)),
        out_specs=P(None, REF_TIME_AXIS), check_vma=False))
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(hist)))
    got = _port(x, taps, hist, n, mode)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert snr_db(ref, got.numpy()) >= VS_KERNEL_DB[mode]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("h", [None, NTAPS - 1, BLOCK])
@pytest.mark.parametrize("n", [2, 4])
def test_shards_equal_unsharded_block2_bitwise(n, h, mode):
    """The kernel's contract: overlapping the exchange with the compute
    changes no bit of the stream's FIR."""
    taps, x, hist = _case(n, 32, h)
    lead = np.zeros((C, BLOCK), np.float32)
    if hist is not None:
        lead[:, BLOCK - h:] = hist
    whole = bf.block2_fir_plain(
        torch.from_numpy(np.concatenate([lead, x], axis=1)), taps, BLOCK,
        mode)
    got = _port(x, taps, hist, n, mode)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


def test_supports_envelope_is_the_reference_one():
    assert hf.halo_fused_supports(8, 1024, 4096)
    assert not hf.halo_fused_supports(8, 1024, 1024)    # < 2 blocks
    assert not hf.halo_fused_supports(8, 1024, 4097)    # ragged
    assert not hf.halo_fused_supports(512, 1024, 4096)  # too many channels
    for c, ntaps, t in itertools.product(
            (0, 1, 8, 256, 257), (2, 129, 1024, 1025, 2049),
            (128, 256, 2048, 2049, 4096, 4224, 327680)):
        assert hf.halo_fused_supports(c, ntaps, t) == \
            rhf.halo_fused_supports(c, ntaps, t), (c, ntaps, t)


def test_rejects_what_the_reference_rejects():
    taps = firwin(1024, 0.25)
    mesh = _cpu_mesh(2)
    one_block = [torch.zeros(4, 1024)] * 2
    with pytest.raises(ValueError, match="unsupported shape"):
        hf.block2_fir_halo_fused(one_block, taps, mesh)
    with pytest.raises(ValueError, match="unsupported shape"):
        rhf.block2_fir_halo_fused(jnp.zeros((4, 1024)), taps, interpret=True)
    two_blocks = [torch.zeros(4, 2048)] * 2
    for h in (1022, 1025):
        with pytest.raises(ValueError, match="history width"):
            hf.block2_fir_halo_fused(two_blocks, taps, mesh,
                                     first_shard_value=torch.zeros(4, h))
        with pytest.raises(ValueError, match="history width"):
            rhf.block2_fir_halo_fused(
                jnp.zeros((4, 2048)), taps, interpret=True,
                first_shard_value=jnp.zeros((4, h)))
    with pytest.raises(ValueError, match="mode"):
        hf.block2_fir_halo_fused(two_blocks, taps, mesh, mode="fast")
    with pytest.raises(ValueError, match="1-D"):
        hf.block2_fir_halo_fused(
            two_blocks * 2, taps,
            pmesh.make_dsp_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="must lie on"):
        hf.block2_fir_halo_fused_cuda(two_blocks, taps, mesh)
