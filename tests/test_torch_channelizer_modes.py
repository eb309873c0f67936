"""The channelizer's sharded modes on CPU meshes: ``(channel, time)``
meshes, ``frames="a2a"`` and ``halo_overlap=True``, against the port's own
unsharded step and streaming and against the JAX ``sharded_step`` under
``shard_map`` on the CPU device mesh (Pallas kernels in interpret mode, as
its own tests run them).  On a CPU mesh the port runs the plain versions
of kernels B1-B4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import llzlab_tpu as rlz
from llzlab_tpu.chains.channelizer import Channelizer as RefChannelizer
from llzlab_tpu.parallel.mesh import CHANNEL_AXIS as RC
from llzlab_tpu.parallel.mesh import TIME_AXIS as RT
from llzlab_tpu.parallel.mesh import make_dsp_mesh as ref_mesh
from llzlab_tpu_torch import Channelizer
from llzlab_tpu_torch.parallel.mesh import (CHANNEL_MAJOR, TIME_AXIS,
                                            DspMesh, gather, make_dsp_mesh,
                                            shard)

#: port against the JAX package (tests/test_torch_channelizer.py)
VS_REFERENCE_DB = 120.0
#: sharded against unsharded streaming; frames="a2a" against the one-shot
#: step; the overlapped step against the exact one (the JAX package's
#: floors, tests/parallel/test_channelizer_sharded.py:92,195,303)
SHARDED_DB, A2A_DB, OVERLAP_DB = 140.0, 110.0, 135.0


def snr_db(ref, y) -> float:
    ref = np.asarray(ref)
    err = np.abs(ref - np.asarray(y)).astype(np.float64)
    perr = float(np.sum(err ** 2))
    return float("inf") if perr == 0.0 else 10.0 * np.log10(
        float(np.sum(np.abs(ref).astype(np.float64) ** 2)) / perr)


def _config(method):
    kw = dict(fir_taps=rlz.firwin(256, 0.4), fft_n=128, fir_method=method)
    if method == "direct":
        kw.update(taps_per_phase=16)
    else:
        kw.update(up=3, down=4, taps_per_phase=8)
    return kw


def _cpu(nc, nt):
    return make_dsp_mesh(nc, nt, devices=["cpu"] * (nc * nt))


def _t_loc(chan):
    m = chan.block_multiple()
    return -(-512 // m) * m  # at least two 256-blocks, for rdma_fused


def _x(seed, c, t):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("method", ["direct", "block2", "fused"])
def test_2d_mesh_matches_unsharded_streaming(method, shape,
                                             monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "high")
    chan = Channelizer(device="cpu", **_config(method))
    nc, nt = shape
    mesh = _cpu(nc, nt)
    t_loc = _t_loc(chan)
    x = torch.from_numpy(_x(91, 16, nt * t_loc))
    chan.validate_sharded_shapes(mesh, 16, x.shape[1])
    step = chan.sharded_step(mesh)
    parts = shard(x, mesh)
    st = st_ref = chan.init_state(16)
    for _ in range(2):  # the second super-block consumes the carried state
        spec, st = step(parts, st)
        frames = []
        for j in range(nt):
            s_, st_ref = chan.step(x[:, j * t_loc:(j + 1) * t_loc], st_ref)
            frames.append(s_)
        ref = torch.cat(frames, dim=1)
        got = gather(spec, mesh, dim=1)
        assert got.shape == ref.shape
        assert snr_db(ref.numpy(), got.numpy()) >= SHARDED_DB
    for a, b in zip(st, st_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ref_step(ref, rmesh, x, **kw):
    axes = tuple(rmesh.axis_names)
    c_ax = RC if RC in axes else None
    step = ref.sharded_step(rmesh, **kw)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(rmesh, P(c_ax, RT)))
    st = tuple(jax.device_put(s, NamedSharding(rmesh, P(c_ax, None)))
               for s in ref.init_state(x.shape[0]))
    spec, st = step(xd, st)
    return np.asarray(spec), st


@pytest.mark.parametrize("method,shape", [("direct", (2, 2)),
                                          ("fused", (2, 4)),
                                          ("block2", (1, 4))])
def test_2d_mesh_matches_reference_sharded_step(method, shape, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    kw = _config(method)
    ref, port = RefChannelizer(**kw), Channelizer(device="cpu", **kw)
    nc, nt = shape
    t_loc = _t_loc(port)
    x = _x(92, 16, nt * t_loc)
    spec_r, st_r = _ref_step(ref, ref_mesh(nc, nt), x)
    mesh = _cpu(nc, nt)
    spec_p, st_p = port.sharded_step(mesh)(shard(torch.from_numpy(x), mesh),
                                           port.init_state(16))
    got = gather(spec_p, mesh, dim=1)
    assert tuple(got.shape) == spec_r.shape
    assert snr_db(spec_r, got.numpy()) >= VS_REFERENCE_DB
    np.testing.assert_array_equal(st_p[0].numpy(), np.asarray(st_r[0]))


def _a2a_t_loc(chan):
    """A per-rank length the FIR and resampler accept that frames do not
    divide (the JAX test's search): the local mode rejects it."""
    m_a2a, m_loc = chan.block_multiple("a2a"), chan.block_multiple("local")
    t_loc = -(-max(chan.h_fir, chan.h_rs, 512) // m_a2a) * m_a2a
    while ((t_loc * chan.up // chan.down) % chan.fft_n == 0
           or t_loc % m_loc == 0):
        t_loc += m_a2a
    return t_loc


@pytest.mark.parametrize("method,shape,halo", [
    ("direct", (2, 4), "ppermute"), ("block2", (1, 4), "ppermute"),
    ("block2", None, "rdma"), ("block2", None, "rdma_fused")])
def test_a2a_frames_straddle_the_ranks(method, shape, halo):
    chan = Channelizer(device="cpu", **_config(method))
    mesh = (DspMesh(["cpu"] * 4, (TIME_AXIS,)) if shape is None
            else _cpu(*shape))
    t_loc = _a2a_t_loc(chan)
    c, t = 16, t_loc * mesh.n_time
    with pytest.raises(ValueError):
        chan.validate_sharded_shapes(mesh, c, t, frames="local")
    chan.validate_sharded_shapes(mesh, c, t, frames="a2a")
    x = torch.from_numpy(_x(93, c, t))
    spec, _ = chan.sharded_step(mesh, halo=halo, frames="a2a")(
        shard(x, mesh), chan.init_state(c))
    assert all(s.shape[0] == c // len(mesh) for s in spec)
    got = gather(spec, mesh, spec=CHANNEL_MAJOR)
    ref, _ = chan.step(x, chan.init_state(c))  # frames over the whole stream
    assert got.shape == ref.shape
    assert snr_db(ref.numpy(), got.numpy()) >= A2A_DB


def test_a2a_matches_reference_sharded_step():
    kw = _config("direct")
    ref, port = RefChannelizer(**kw), Channelizer(device="cpu", **kw)
    t_loc = _a2a_t_loc(port)
    x = _x(94, 8, 4 * t_loc)
    spec_r, _ = _ref_step(ref, ref_mesh(2, 4), x, frames="a2a")
    mesh = _cpu(2, 4)
    spec, _ = port.sharded_step(mesh, frames="a2a")(
        shard(torch.from_numpy(x), mesh), port.init_state(8))
    got = gather(spec, mesh, spec=CHANNEL_MAJOR)
    assert tuple(got.shape) == spec_r.shape
    assert snr_db(spec_r, got.numpy()) >= VS_REFERENCE_DB


def _two_steps(chan, mesh, parts, c, **kw):
    step = chan.sharded_step(mesh, **kw)
    st = chan.init_state(c)
    outs = []
    for _ in range(2):  # the carried state gives a nonzero halo
        spec, st = step(parts, st)
        outs.append(gather(spec, mesh, dim=1).numpy())
    return outs


@pytest.mark.parametrize("halo", ["ppermute", "rdma"])
@pytest.mark.parametrize("method", ["block2", "fused"])
def test_halo_overlap_matches_the_exact_step(method, halo, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    chan = Channelizer(device="cpu", **_config(method))
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,))
    x = torch.from_numpy(_x(95, 8, 4 * chan.block_multiple()))
    parts = shard(x, mesh)
    over = _two_steps(chan, mesh, parts, 8, halo=halo, halo_overlap=True)
    exact = _two_steps(chan, mesh, parts, 8, halo=halo)
    for a, b in zip(exact, over):
        assert snr_db(a, b) >= OVERLAP_DB
    mesh2 = _cpu(2, 2)  # per channel row, too
    over2 = _two_steps(chan, mesh2, shard(x, mesh2), 8, halo_overlap=True)
    exact2 = _two_steps(chan, mesh2, shard(x, mesh2), 8)
    for a, b in zip(exact2, over2):
        assert snr_db(a, b) >= OVERLAP_DB


@pytest.mark.parametrize("method", ["block2", "fused"])
def test_halo_overlap_matches_reference_overlapped_step(method, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    kw = _config(method)
    ref, port = RefChannelizer(**kw), Channelizer(device="cpu", **kw)
    x = _x(96, 8, 4 * port.block_multiple())
    rmesh = Mesh(np.asarray(jax.devices()[:4]), (RT,))
    spec_r, _ = _ref_step(ref, rmesh, x, halo_overlap=True)
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,))
    spec, _ = port.sharded_step(mesh, halo_overlap=True)(
        shard(torch.from_numpy(x), mesh), port.init_state(8))
    assert snr_db(spec_r, gather(spec, mesh, dim=1).numpy()) \
        >= VS_REFERENCE_DB


def test_modes_reject_what_the_reference_rejects():
    port_b = Channelizer(device="cpu", **_config("block2"))
    port_d = Channelizer(device="cpu", fir_method="ols",
                         fir_taps=rlz.firwin(256, 0.4), fft_n=128)
    mesh2 = _cpu(2, 2)
    for halo in ("rdma", "rdma_fused"):
        with pytest.raises(ValueError, match="1-D"):
            port_b.sharded_step(mesh2, halo=halo)
    with pytest.raises(ValueError, match="halo_overlap"):
        port_d.sharded_step(mesh2, halo_overlap=True)
    with pytest.raises(ValueError, match="compose"):
        port_b.sharded_step(DspMesh(["cpu"] * 4, (TIME_AXIS,)),
                            halo="rdma_fused", halo_overlap=True)
    remote = DspMesh(["cpu"] * 4, (TIME_AXIS,), processes=[0, 0, 1, 1])
    for halo in ("ppermute", "rdma", "rdma_fused"):  # all run across
        port_b.sharded_step(remote, halo=halo)  # processes, as the JAX one
    with pytest.raises(ValueError, match="mesh"):
        port_b.sharded_step(DspMesh(["cpu"] * 2, ("stage",)))
