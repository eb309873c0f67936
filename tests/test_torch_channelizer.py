"""The port's channelizer on the CPU, against the JAX package: the
unsharded step, and the time-sharded step on a 4-rank CPU mesh against the
port's own unsharded streaming and against the JAX ``sharded_step`` under
``shard_map`` (Pallas kernels in interpret mode, as its own tests run
them).  On a CPU mesh the port runs the plain versions of kernels B1-B4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import llzlab_tpu as rlz
from llzlab_tpu.chains.channelizer import Channelizer as RefChannelizer
from llzlab_tpu.parallel.mesh import TIME_AXIS as REF_TIME_AXIS
from llzlab_tpu.parallel.mesh import make_dsp_mesh as ref_make_dsp_mesh
from llzlab_tpu_torch import (Channelizer, gather_time, make_dsp_mesh,
                              pair_to_complex, shard_time)
from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh
from llzlab_tpu_torch.utils.checkpoint import from_reference

N = 4
#: port against the JAX package: f32 engines that sum in another order
VS_REFERENCE_DB = 120.0
#: sharded against unsharded streaming (the JAX package's own floor; the
#: port's locals are bit-exact, so this reads inf)
SHARDED_DB = 140.0


def snr_db(ref, y) -> float:
    """Signal-to-error ratio in dB of real or complex arrays."""
    ref = np.asarray(ref)
    err = np.abs(ref - np.asarray(y)).astype(np.float64)
    perr = float(np.sum(err ** 2))
    return float("inf") if perr == 0.0 else 10.0 * np.log10(
        float(np.sum(np.abs(ref).astype(np.float64) ** 2)) / perr)


def _config(method, spec_format="complex"):
    """The small flagship of the JAX package's sharded tests."""
    kw = dict(fir_taps=rlz.firwin(256, 0.4), fft_n=128, fir_method=method,
              spec_format=spec_format)
    if method == "direct":
        kw.update(taps_per_phase=16)
    else:
        kw.update(up=3, down=4, taps_per_phase=8)
    return kw


def _pair(method, spec_format="complex"):
    kw = _config(method, spec_format)
    return RefChannelizer(**kw), Channelizer(device="cpu", **kw)


def _cpu_mesh(n=N):
    return DspMesh(["cpu"] * n, (TIME_AXIS,))


def _t_loc(chan):
    m = chan.block_multiple()
    return -(-512 // m) * m  # at least two 256-blocks, for rdma_fused


def _streaming(chan, x, t_loc, n_steps):
    st = chan.init_state(x.shape[0])
    outs = []
    for _ in range(n_steps):
        frames = []
        for j in range(x.shape[1] // t_loc):
            spec, st = chan.step(x[:, j * t_loc:(j + 1) * t_loc], st)
            frames.append(spec)
        outs.append(torch.cat(frames, dim=1))
    return outs, st


@pytest.mark.parametrize("spec_format", ["complex", "pair"])
@pytest.mark.parametrize("method", ["direct", "block2", "fused"])
def test_step_matches_reference(method, spec_format, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    ref, port = _pair(method, spec_format)
    assert port.block_multiple() == ref.block_multiple()
    assert port.block_multiple("a2a") == ref.block_multiple("a2a")
    assert (port.h_fir, port.h_rs, port.k, port.nfft) == \
        (ref.h_fir, ref.h_rs, ref.k, ref.nfft)
    t = port.block_multiple()
    x = np.random.default_rng(61).standard_normal((8, 2 * t)).astype(
        np.float32)
    st_r, st_p = ref.init_state(8), port.init_state(8)
    assert [tuple(s.shape) for s in st_p] == [tuple(s.shape) for s in st_r]
    for j in range(2):  # the second step consumes the carried state
        blk = x[:, j * t:(j + 1) * t]
        spec_r, st_r = ref.step(jnp.asarray(blk), st_r)
        spec_p, st_p = port.step(torch.from_numpy(blk), st_p)
        assert tuple(spec_p.shape) == tuple(spec_r.shape)
        assert snr_db(np.asarray(spec_r), spec_p.numpy()) >= VS_REFERENCE_DB
    # the FIR state is a slice of the input
    np.testing.assert_array_equal(st_p[0].numpy(), np.asarray(st_r[0]))
    assert st_p[1].shape == st_r[1].shape
    if spec_format == "pair":
        assert spec_p.shape[-1] == port.fft_n + 2
        first = torch.from_numpy(x[:, :t])
        cplx, _ = Channelizer(device="cpu", **_config(method)).step(
            first, port.init_state(8))
        pair, _ = port.step(first, port.init_state(8))
        assert snr_db(cplx.numpy(), pair_to_complex(pair).numpy()) >= 140.0


@pytest.mark.parametrize("t_mult", [1.0, 0.5])
def test_fused_step_without_the_history_gives_the_same_signal(t_mult):
    """``return_zf=False`` (the sharded step's use) skips only the new
    history: inside the kernel's envelope, and on the unfused pair that
    runs outside it (half a program of samples)."""
    chan = Channelizer(device="cpu", **_config("fused"))
    t = int(chan.block_multiple("a2a") * t_mult)
    rng = np.random.default_rng(63)
    x = torch.from_numpy(rng.standard_normal((8, t)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal(
        (8, chan.h_fir)).astype(np.float32))
    z, zf = chan._fused_step(x, hist)
    assert zf.shape == hist.shape
    assert torch.equal(chan._fused_step(x, hist, return_zf=False), z)


def test_auto_method_resolves_per_device_as_the_reference_does():
    kw = dict(fir_taps=rlz.firwin(256, 0.4), fft_n=128, taps_per_phase=8,
              up=3, down=4)
    assert RefChannelizer(**kw).fir_method == "ols"  # JAX on the CPU
    assert Channelizer(device="cpu", **kw).fir_method == "ols"
    assert Channelizer(device="cuda", **kw).fir_method == "fused"
    # outside the fused kernel's static envelope: block2, then ols
    assert Channelizer(device="cuda", fir_taps=rlz.firwin(256, 0.4),
                       up=3, down=4, taps_per_phase=512).fir_method == "block2"
    assert Channelizer(device="cuda", fir_taps=rlz.firwin(2051, 0.4),
                       up=3, down=4, taps_per_phase=8).fir_method == "ols"
    with pytest.raises(ValueError, match="fused"):
        Channelizer(device="cpu", fir_method="fused",
                    fir_taps=rlz.firwin(2051, 0.4))
    with pytest.raises(ValueError, match="spec_format"):
        Channelizer(device="cpu", spec_format="polar")


@pytest.mark.parametrize("method,halo", [
    ("direct", "ppermute"), ("direct", "rdma"), ("ols", "ppermute"),
    ("block2", "ppermute"), ("block2", "rdma"), ("block2", "rdma_fused"),
    ("fused", "ppermute"), ("fused", "rdma"),
])
def test_sharded_matches_unsharded_streaming(method, halo, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "high")
    chan = Channelizer(device="cpu", **_config(method))
    mesh = _cpu_mesh()
    t_loc = _t_loc(chan)
    x = torch.from_numpy(np.random.default_rng(62).standard_normal(
        (8, N * t_loc)).astype(np.float32))
    chan.validate_sharded_shapes(mesh, 8, x.shape[1])
    step = chan.sharded_step(mesh, halo=halo)
    st = chan.init_state(8)
    parts = shard_time(x, mesh)
    outs = []
    for _ in range(2):  # the second super-block consumes the carried state
        spec, st = step(parts, st)
        outs.append(gather_time(spec, mesh, dim=1))
    refs, st_ref = _streaming(chan, x, t_loc, 2)
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape
        assert snr_db(ref.numpy(), got.numpy()) >= SHARDED_DB
    for a, b in zip(st, st_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method,halo", [
    ("direct", "ppermute"), ("direct", "rdma"), ("block2", "rdma_fused")])
def test_sharded_matches_reference_sharded_step(method, halo, monkeypatch):
    monkeypatch.setenv("LLZ_MATMUL_PRECISION", "highest")
    ref, port = _pair(method)
    t_loc = _t_loc(port)
    x = np.random.default_rng(63).standard_normal(
        (8, N * t_loc)).astype(np.float32)
    rmesh = Mesh(np.asarray(jax.devices()[:N]), (REF_TIME_AXIS,))
    ref.validate_sharded_shapes(rmesh, 8, x.shape[1])
    rstep = ref.sharded_step(rmesh, halo=halo)
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(rmesh, P(None, REF_TIME_AXIS)))
    rst = tuple(jax.device_put(s, NamedSharding(rmesh, P(None, None)))
                for s in ref.init_state(8))
    spec_r, rst = rstep(xd, rst)
    mesh = _cpu_mesh()
    spec_p, st = port.sharded_step(mesh, halo=halo)(
        shard_time(torch.from_numpy(x), mesh), port.init_state(8))
    got = gather_time(spec_p, mesh, dim=1)
    assert tuple(got.shape) == tuple(spec_r.shape)
    assert snr_db(np.asarray(spec_r), got.numpy()) >= VS_REFERENCE_DB
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(rst[0]))
    # the reference's state crosses over as numpy and resumes the port
    carried = from_reference(tuple(np.asarray(s) for s in rst), "cpu")
    assert [tuple(s.shape) for s in carried] == [tuple(s.shape) for s in st]
    spec2, _ = port.sharded_step(mesh, halo=halo)(
        shard_time(torch.from_numpy(x), mesh), carried)
    spec2_r, _ = rstep(xd, rst)
    assert snr_db(np.asarray(spec2_r),
                  gather_time(spec2, mesh, dim=1).numpy()) >= VS_REFERENCE_DB


def test_sharded_step_rejects_what_the_reference_rejects():
    ref_d, port_d = _pair("direct")
    ref_b, port_b = _pair("block2")
    mesh1, mesh2 = _cpu_mesh(), make_dsp_mesh(2, 2, devices=["cpu"] * 4)
    rmesh1 = Mesh(np.asarray(jax.devices()[:N]), (REF_TIME_AXIS,))
    rmesh2 = ref_make_dsp_mesh(2, 2)
    for chan_r, chan_p, kw, match in (
            (ref_d, port_d, dict(halo="rdma"), "1-D"),
            (ref_b, port_b, dict(halo="rdma_fused"), "1-D"),
            (ref_d, port_d, dict(halo="nccl"), "unknown halo"),
            (ref_d, port_d, dict(frames="ragged"), "unknown frames"),
            (ref_d, port_d, dict(halo_overlap=True), "halo_overlap")):
        for chan, mesh in ((chan_r, rmesh2), (chan_p, mesh2)):
            with pytest.raises(ValueError, match=match):
                chan.sharded_step(mesh, **kw)
    for kw, match in ((dict(halo="rdma_fused"), "block2"),):
        for chan, mesh in ((ref_d, rmesh1), (port_d, mesh1)):
            with pytest.raises(ValueError, match=match):
                chan.sharded_step(mesh, **kw)
    for chan, mesh in ((ref_b, rmesh1), (port_b, mesh1)):
        with pytest.raises(ValueError, match="compose"):
            chan.sharded_step(mesh, halo="rdma_fused", halo_overlap=True)


def test_validate_sharded_shapes_matches_reference():
    ref, port = _pair("direct")
    mesh, rmesh = _cpu_mesh(), Mesh(np.asarray(jax.devices()[:N]),
                                    (REF_TIME_AXIS,))
    m = port.block_multiple()
    port.validate_sharded_shapes(mesh, 8, N * m)
    for c, t, match in ((8, N * m + 2, "not divisible by n_time"),
                        (8, N * (m + port.down), "must be a multiple")):
        for chan, msh in ((ref, rmesh), (port, mesh)):
            with pytest.raises(ValueError, match=match):
                chan.validate_sharded_shapes(msh, c, t)
    mesh2 = make_dsp_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="n_channel"):
        port.validate_sharded_shapes(mesh2, 7, 2 * m)
    with pytest.raises(ValueError, match="device count"):
        port.validate_sharded_shapes(mesh2, 6, 2 * port.block_multiple("a2a"),
                                     frames="a2a")


@pytest.mark.parametrize("method", ["direct", "fused"])
def test_state_crosses_from_reference_and_through_a_checkpoint(method,
                                                               tmp_path):
    """The channelizer's pair state, the fused engine's ``(2·block, 0)``
    pair included, comes over from the JAX package as numpy and survives
    the port's save/load."""
    from llzlab_tpu_torch.utils.checkpoint import load_state, save_state

    ref, port = _pair(method)
    t = port.block_multiple()
    x = np.random.default_rng(64).standard_normal((8, t)).astype(np.float32)
    _, rst = ref.step(jnp.asarray(x), ref.init_state(8))
    _, pst = port.step(torch.from_numpy(x), port.init_state(8))
    carried = from_reference(tuple(np.asarray(s) for s in rst), "cpu")
    assert isinstance(carried, tuple) and len(carried) == 2
    for a, b in zip(carried, pst):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(carried[0].numpy(), pst[0].numpy())
    path = str(tmp_path / "state.npz")
    save_state(path, carried, block_index=1)
    loaded, block_index, _ = load_state(path, like=port.init_state(8))
    assert block_index == 1
    for a, b in zip(loaded, carried):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
