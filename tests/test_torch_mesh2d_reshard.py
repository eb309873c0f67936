"""The port's ``(channel, time)`` mesh, its layouts and the all-to-all
reshard on CPU meshes, against the JAX package under ``shard_map`` on the
CPU device mesh: the split and its inverse, the halo exchange per channel
row, and the reshard, bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from llzlab_tpu.parallel import halo as rhalo
from llzlab_tpu.parallel import reshard as rrs
from llzlab_tpu.parallel.mesh import CHANNEL_AXIS as RC
from llzlab_tpu.parallel.mesh import TIME_AXIS as RT
from llzlab_tpu.parallel.mesh import channel_time_spec as ref_spec
from llzlab_tpu.parallel.mesh import make_dsp_mesh as ref_mesh
from llzlab_tpu_torch.kernels import halo_ring as hr
from llzlab_tpu_torch.parallel import halo as ph
from llzlab_tpu_torch.parallel import mesh as pm
from llzlab_tpu_torch.parallel import reshard as prs


def _cpu(nc, nt):
    return pm.make_dsp_mesh(nc, nt, devices=["cpu"] * (nc * nt))


def _x(seed, c, t):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (2, 2), (4, 1)])
def test_shard_puts_channel_and_time_blocks_in_row_major_order(shape):
    nc, nt = shape
    mesh = _cpu(nc, nt)
    x = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)
    parts = pm.shard(x, mesh)
    cl, tl = 8 // nc, 64 // nt
    for r, part in enumerate(parts):
        c, t = mesh.coords(r)
        assert (c, t) == (r // nt, r % nt)
        assert torch.equal(part, x[c * cl:(c + 1) * cl, t * tl:(t + 1) * tl])
    assert mesh.rows() == [list(range(c * nt, (c + 1) * nt))
                           for c in range(nc)]
    assert torch.equal(pm.gather(parts, mesh), x)
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard(x[:, :63], mesh) if nt > 1 else pm.shard(x[:7], mesh)


def test_layout_names_are_the_reference_specs():
    assert pm.channel_time_spec() == tuple(ref_spec()) == (RC, RT)
    assert pm.CHANNEL_MAJOR == tuple(P((RC, RT), None))
    assert (pm.CHANNEL_AXIS, pm.TIME_AXIS) == (RC, RT)
    with pytest.raises(ValueError, match="unknown layout"):
        pm.shard(torch.zeros(8, 8), _cpu(2, 2), spec=(RT, RC))


def test_a_channel_row_is_a_time_ring_sharing_the_ranks():
    mesh = _cpu(2, 4)
    row = mesh.row(1)
    assert row.axis_names == (pm.TIME_AXIS,) and len(row) == 4
    assert all(a is b for a, b in zip(row.ranks, mesh.ranks[4:]))
    assert mesh.row(1) is row  # made once: its cache persists
    one = pm.DspMesh(["cpu"] * 4, (pm.TIME_AXIS,))
    assert one.row(0) is one and one.rows() == [[0, 1, 2, 3]]
    assert (mesh.n_channel, mesh.n_time) == (2, 4)


@pytest.mark.parametrize("shape,c,t", [((2, 4), 8, 1024), ((2, 4), 16, 512),
                                       ((2, 2), 8, 1024), ((1, 4), 8, 256)])
def test_reshard_round_trip_is_the_identity(shape, c, t):
    mesh = _cpu(*shape)
    x = torch.from_numpy(_x(141 + c, c, t))
    parts = pm.shard(x, mesh)
    cm = prs.to_channel_major(parts, mesh)
    n = len(mesh)
    assert all(p.shape == (c // n, t) for p in cm)
    assert torch.equal(pm.gather(cm, mesh, spec=pm.CHANNEL_MAJOR), x)
    assert all(torch.equal(a, b) for a, b in zip(
        cm, pm.shard(x, mesh, spec=pm.CHANNEL_MAJOR)))
    back = prs.to_time_major(cm, mesh)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    assert all(torch.equal(a, b) for a, b in zip(
        prs.reshard(parts, mesh, pm.CHANNEL_MAJOR), cm))


@pytest.mark.parametrize("fn", ["to_channel_major", "all_to_all_shard_map"])
def test_reshard_matches_reference_per_device(fn):
    """Each rank's block is the block of the JAX device at the same mesh
    position, bit for bit."""
    rmesh = ref_mesh(2, 4)
    x = _x(143, 8, 1024)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(rmesh, P(RC, RT)))
    if fn == "to_channel_major":
        out = jax.jit(lambda v: rrs.to_channel_major(v, rmesh))(xd)
    else:
        out = rrs.all_to_all_shard_map(xd, rmesh)
    mesh = _cpu(2, 4)
    cm = getattr(prs, fn)(pm.shard(torch.from_numpy(x), mesh), mesh)
    devices = list(rmesh.devices.flat)
    for shard in out.addressable_shards:
        np.testing.assert_array_equal(
            cm[devices.index(shard.device)].numpy(), np.asarray(shard.data))
    np.testing.assert_array_equal(np.asarray(out), x)


def test_reshard_rejects_other_layouts_and_shapes():
    mesh = _cpu(2, 4)
    parts = pm.shard(torch.zeros(8, 64), mesh)
    with pytest.raises(ValueError, match="reshard moves between"):
        prs.reshard(parts, mesh, (RT, None))
    with pytest.raises(ValueError, match="not divisible by n_time"):
        prs.to_channel_major(pm.shard(torch.zeros(4, 64), mesh), mesh)
    with pytest.raises(ValueError, match="blocks for"):
        prs.to_channel_major(parts[:3], mesh)


def _ref_per_row(fn, x, state, out_w):
    """``fn`` under ``shard_map`` on the JAX (2, 4) mesh, each rank's
    ``(C_loc, out_w)`` result joined as the port's ``gather`` joins."""
    rmesh = ref_mesh(2, 4)
    f = jax.shard_map(fn, mesh=rmesh, in_specs=(P(RC, RT), P(RC, None)),
                      out_specs=P(RC, RT), check_vma=False)
    return np.asarray(f(jnp.asarray(x), jnp.asarray(state)))


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("h", [5, 63])
def test_left_halo_runs_per_channel_row_as_the_reference(h, with_carry):
    x = _x(144, 8, 4 * 128)
    st = (np.random.default_rng(145).standard_normal((8, h)).astype(
        np.float32) if with_carry else np.zeros((8, h), np.float32))
    ref = _ref_per_row(lambda v, s: rhalo.left_halo(
        v, h, first_shard_value=s if with_carry else None), x, st, h)
    mesh = _cpu(2, 4)
    parts = pm.shard(torch.from_numpy(x), mesh)
    got = ph.left_halo(parts, h, mesh, first_shard_value=ph.row_values(
        torch.from_numpy(st), mesh) if with_carry else None)
    np.testing.assert_array_equal(pm.gather(got, mesh).numpy(), ref)
    tails = ph.broadcast_from_last([p[:, -h:] for p in parts], mesh)
    ref_b = _ref_per_row(lambda v, s: rhalo.broadcast_from_last(
        v[:, -h:]), x, st, h)
    np.testing.assert_array_equal(pm.gather(tails, mesh).numpy(), ref_b)


def test_right_halo_takes_the_right_neighbours_head():
    mesh = _cpu(2, 2)
    x = torch.arange(4 * 16, dtype=torch.float32).reshape(4, 16)
    got = ph.right_halo(pm.shard(x, mesh), 3, mesh)
    assert torch.equal(got[0], x[:2, 8:11]) and torch.equal(got[2],
                                                            x[2:, 8:11])
    assert not got[1].any() and not got[3].any()


def test_exchanges_refuse_what_they_cannot_serve():
    mesh = _cpu(2, 2)
    parts = pm.shard(torch.zeros(4, 256), mesh)
    with pytest.raises(ValueError, match="per row"):
        ph.left_halo(parts, 8, mesh, first_shard_value=torch.zeros(4, 8))
    with pytest.raises(ValueError, match="1-D"):
        hr.left_halo_ring(parts, 8, mesh)
    # a time mesh holding ranks of another process: the kernels reach
    # them through CUDA IPC within one host, through NCCL between two
    remote = pm.DspMesh(["cpu"] * 4, (pm.TIME_AXIS,), processes=[0, 0, 1, 1])
    assert remote.is_distributed and remote.local(1) and not remote.local(2)
    assert hr.mesh_plan(remote) == ([[0, 1]], [hr.DIRECT, hr.PROCESS,
                                               hr.DIRECT])
    places = [(None, "cpu")] * 2 + [(1, "cpu")] * 2
    assert hr.edge_plan(places, hosts=["a", "a", "b", "b"]) == (
        [[0, 1]], [hr.DIRECT, hr.NET, hr.DIRECT])
    with pytest.raises(ValueError, match="lives in process 1"):
        with remote.on(3):
            pass
