"""The port's rank mesh and halo exchange on CPU meshes, against the JAX
package under ``shard_map`` on the CPU device mesh.  The JAX ring kernel
runs in interpret mode, as its own tests run it; on a CPU mesh the port
runs the plain version of its CUDA kernel B3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from llzlab_tpu.kernels.halo_ring import left_halo_ring as ref_ring
from llzlab_tpu.parallel import halo as rhalo
from llzlab_tpu.parallel.mesh import TIME_AXIS as REF_TIME_AXIS
from llzlab_tpu_torch.kernels import halo_ring as hr
from llzlab_tpu_torch.parallel import halo as phalo
from llzlab_tpu_torch.parallel import mesh as pmesh

N = 4


def _ref(fn, x, n=N):
    mesh = Mesh(np.asarray(jax.devices()[:n]), (REF_TIME_AXIS,))
    f = jax.shard_map(fn, mesh=mesh, in_specs=P(None, REF_TIME_AXIS),
                      out_specs=P(None, REF_TIME_AXIS), check_vma=False)
    return np.asarray(f(jnp.asarray(x)))


def _cpu_mesh(n=N):
    return pmesh.DspMesh(["cpu"] * n, (pmesh.TIME_AXIS,))


def _case(seed, h, with_carry):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, N * 128)).astype(np.float32)
    carry = (rng.standard_normal((4, h)).astype(np.float32)
             if with_carry else None)
    return x, carry


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("h", [8, 63])
def test_left_halo_matches_reference(h, with_carry):
    x, carry = _case(171, h, with_carry)
    ref = _ref(lambda v: rhalo.left_halo(
        v, h, first_shard_value=None if carry is None
        else jnp.asarray(carry)), x)
    mesh = _cpu_mesh()
    parts = pmesh.shard_time(torch.from_numpy(x), mesh)
    got = phalo.left_halo(
        parts, h, mesh,
        first_shard_value=None if carry is None else torch.from_numpy(carry))
    assert all(g.shape == (4, h) and g.is_contiguous() for g in got)
    np.testing.assert_array_equal(
        pmesh.gather_time(got, mesh).numpy(), ref)


@pytest.mark.parametrize("with_carry", [False, True])
def test_left_halo_ring_plain_matches_reference_kernel(with_carry):
    h = 16
    x, carry = _case(172, h, with_carry)
    ref = _ref(lambda v: ref_ring(
        v, h, axis_names=(REF_TIME_AXIS,), interpret=True,
        first_shard_value=None if carry is None else jnp.asarray(carry)), x)
    mesh = _cpu_mesh()
    parts = pmesh.shard_time(torch.from_numpy(x), mesh)
    before = hr.left_halo_ring_cuda.launches
    got = hr.left_halo_ring(
        parts, h, mesh,
        first_shard_value=None if carry is None else torch.from_numpy(carry))
    assert hr.left_halo_ring_cuda.launches == before  # CPU mesh: plain
    np.testing.assert_array_equal(
        pmesh.gather_time(got, mesh).numpy(), ref)
    if carry is not None:
        np.testing.assert_array_equal(got[0].numpy(), carry)
    np.testing.assert_array_equal(got[1].numpy(), x[:, 128 - h:128])


def test_broadcast_from_last_matches_reference():
    x, _ = _case(173, 8, False)
    ref = _ref(lambda v: rhalo.broadcast_from_last(v[..., -8:]), x)
    mesh = _cpu_mesh()
    parts = pmesh.shard_time(torch.from_numpy(x), mesh)
    got = phalo.broadcast_from_last([p[..., -8:] for p in parts], mesh)
    np.testing.assert_array_equal(pmesh.gather_time(got, mesh).numpy(), ref)
    assert all(g.is_contiguous() for g in got)
    got[0].zero_()  # each rank holds a copy of its own
    np.testing.assert_array_equal(got[1].numpy(), x[:, -8:])


def test_shard_and_gather_time_round_trip():
    x, _ = _case(174, 8, False)
    mesh = _cpu_mesh()
    parts = pmesh.shard_time(torch.from_numpy(x), mesh)
    assert len(parts) == N and all(
        p.shape == (4, 128) and p.is_contiguous() for p in parts)
    np.testing.assert_array_equal(pmesh.gather_time(parts, mesh).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_time(torch.zeros(4, 130), mesh)
    with pytest.raises(ValueError, match="1-D"):
        pmesh.shard_time(torch.zeros(4, 128),
                         pmesh.make_dsp_mesh(2, 2, devices=["cpu"] * 4))


def test_make_dsp_mesh_shapes_follow_reference():
    mesh = pmesh.make_dsp_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.axis_names == (pmesh.CHANNEL_AXIS, pmesh.TIME_AXIS)
    assert mesh.shape == {"channel": 2, "time": 4} and len(mesh) == 8
    assert (pmesh.CHANNEL_AXIS, pmesh.TIME_AXIS) == ("channel", "time")
    # device count alone: the split favours the time axis; a smaller shape
    # uses a prefix
    assert pmesh.make_dsp_mesh(devices=["cpu"] * 6).shape == {
        "channel": 3, "time": 2}
    assert len(pmesh.make_dsp_mesh(1, 2, devices=["cpu"] * 8)) == 2
    with pytest.raises(ValueError, match="more than"):
        pmesh.make_dsp_mesh(4, 4, devices=["cpu"] * 8)
    assert not mesh.is_cuda


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_dsp_mesh(1, 4)


def test_ring_rejects_meshes_and_shards_it_cannot_serve():
    mesh2d = pmesh.make_dsp_mesh(2, 2, devices=["cpu"] * 4)
    parts = [torch.zeros(4, 128)] * 4
    with pytest.raises(ValueError, match="1-D"):
        hr.left_halo_ring(parts, 8, mesh2d)
    with pytest.raises(ValueError, match="shards for"):
        hr.left_halo_ring(parts[:3], 8, _cpu_mesh())
    with pytest.raises(ValueError, match="must lie on"):
        hr.left_halo_ring_cuda(parts, 8, _cpu_mesh())
