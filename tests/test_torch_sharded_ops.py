"""The port's sharded ops on CPU meshes: FIR and resampling bitwise the
port's unsharded streaming at ``T_loc`` granularity, the IIR carry
composition against ``sosfilt`` and scipy float64, the FFT frames against
numpy, the plan counters; each against the JAX package's sharded op under
``shard_map`` on the CPU device mesh, at the shapes of its own tests
(``tests/parallel/test_sharded_ops.py``)."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import llzlab_tpu as rlz
from llzlab_tpu.parallel import sharded_ops as rso
from llzlab_tpu.parallel.mesh import CHANNEL_AXIS as RC
from llzlab_tpu.parallel.mesh import TIME_AXIS as RT
from llzlab_tpu.parallel.mesh import make_dsp_mesh as ref_mesh
from llzlab_tpu_torch.ops.fir import fir_filter
from llzlab_tpu_torch.ops.iir import peaking_eq_sos, sosfilt
from llzlab_tpu_torch.ops.resample import resample_poly, resample_taps
from llzlab_tpu_torch.parallel import sharded_ops as so
from llzlab_tpu_torch.parallel.mesh import gather, make_dsp_mesh, shard
from tests.conftest import snr_db

EQ = peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400, 12800],
                    [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)
#: the port against the JAX package: two float32 computations
VS_REFERENCE_DB = 120.0
#: the IIR composition against unsharded, and against scipy float64
#: (tests/parallel/test_sharded_ops.py:111,121); the FFT frames against
#: numpy (:178)
IIR_DB, IIR_F64_DB, FFT_DB = 135.0, 120.0, 110.0


def _cpu(nc, nt):
    return make_dsp_mesh(nc, nt, devices=["cpu"] * (nc * nt))


def _x(seed, c, t):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


def _ref(fn, x, *args, **kw):
    rmesh = ref_mesh(2, 4)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(rmesh, P(RC, RT)))
    return np.asarray(fn(xd, *args, rmesh, **kw))


def _stream(op, x, t_loc, **kw):
    """The port's unsharded op over ``x`` in ``t_loc`` pieces, the
    history carried."""
    zi, outs = None, []
    for j in range(x.shape[-1] // t_loc):
        y, zi = op(x[:, j * t_loc:(j + 1) * t_loc], zi=zi, return_zf=True,
                   **kw)
        outs.append(y)
    return torch.cat(outs, dim=-1), zi


@pytest.mark.parametrize("method", ["ols", "block2"])
@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (4, 1)])
def test_fir_sharded_is_unsharded_streaming_bitwise(shape, method):
    taps = rlz.firwin(512, 0.25)
    t_loc = 3072  # a multiple of the 512-tap OLS hop 1536
    nc, nt = shape
    mesh = _cpu(nc, nt)
    x = torch.from_numpy(_x(61, 8, nt * t_loc))
    y, st = so.fir_filter_sharded(shard(x, mesh), taps, mesh, method=method,
                                  return_state=True)
    ref, zf = _stream(lambda v, **kw: fir_filter(v, taps, method=method,
                                                 **kw), x, t_loc)
    assert torch.equal(gather(y, mesh), ref)
    assert torch.equal(st, zf)


def test_fir_sharded_super_blocks_carry_the_state():
    taps = rlz.firwin(512, 0.25)
    mesh = _cpu(2, 4)
    x = torch.from_numpy(_x(62, 4, 8 * 3072))
    y1, st = so.fir_filter_sharded(shard(x[:, :4 * 3072], mesh), taps, mesh,
                                   return_state=True)
    y2 = so.fir_filter_sharded(shard(x[:, 4 * 3072:], mesh), taps, mesh,
                               state=st)
    ref, _ = _stream(lambda v, **kw: fir_filter(v, taps, method="ols", **kw),
                     x, 3072)
    assert torch.equal(torch.cat([gather(y1, mesh), gather(y2, mesh)], -1),
                       ref)


def test_fir_sharded_matches_reference():
    taps = rlz.firwin(512, 0.25)
    x = _x(61, 8, 4 * 3072)
    ref = _ref(rso.fir_filter_sharded, x, taps)
    mesh = _cpu(2, 4)
    got = gather(so.fir_filter_sharded(shard(torch.from_numpy(x), mesh),
                                       taps, mesh), mesh)
    assert snr_db(ref, got.numpy()) >= VS_REFERENCE_DB


def test_resample_sharded_is_unsharded_streaming_bitwise():
    rt = resample_taps(147, 160, 64)
    t_loc = 1600
    mesh = _cpu(2, 4)
    x = _x(64, 8, 4 * t_loc)
    y, st = so.resample_sharded(shard(torch.from_numpy(x), mesh), 147, 160,
                                mesh, taps=rt, return_state=True)
    got = gather(y, mesh)
    assert got.shape == (8, 4 * 1470)
    ref, zf = _stream(lambda v, **kw: resample_poly(v, 147, 160, taps=rt,
                                                    **kw),
                      torch.from_numpy(x), t_loc)
    assert torch.equal(got, ref) and torch.equal(st, zf)
    ref_j = _ref(rso.resample_sharded, x, 147, 160, taps=rt)
    assert snr_db(ref_j, got.numpy()) >= VS_REFERENCE_DB


def test_ops_check_the_local_length_as_the_reference_does():
    mesh = _cpu(1, 4)
    with pytest.raises(ValueError, match="history"):
        so.fir_filter_sharded(shard(torch.zeros(2, 4 * 256), mesh),
                              rlz.firwin(512, 0.25), mesh)
    with pytest.raises(ValueError, match="multiple of down"):
        so.resample_sharded(shard(torch.zeros(2, 4 * 1000), mesh), 147, 160,
                            mesh)
    with pytest.raises(ValueError, match="multiple of n"):
        so.fft_frames_sharded(shard(torch.zeros(2, 4 * 1000), mesh), 2048,
                              mesh)
    with pytest.raises(ValueError, match="blocks for"):
        so.sosfilt_sharded([torch.zeros(2, 8)] * 3, EQ, mesh)


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (2, 2)])
def test_sosfilt_sharded_against_sosfilt_and_float64(shape):
    x = _x(65, 8, 4 * 2048)
    mesh = _cpu(*shape)
    got = gather(so.sosfilt_sharded(shard(torch.from_numpy(x), mesh), EQ,
                                    mesh, block_size=1024), mesh).numpy()
    ref = sosfilt(EQ, torch.from_numpy(x), block_size=1024).numpy()
    assert snr_db(ref, got) >= IIR_DB
    assert snr_db(ss.sosfilt(EQ, x.astype(np.float64), axis=-1),
                  got) >= IIR_F64_DB


def test_sosfilt_sharded_with_one_time_rank_is_sosfilt_bitwise():
    x = torch.from_numpy(_x(67, 16, 4096))
    mesh = _cpu(4, 1)
    y, st = so.sosfilt_sharded(shard(x, mesh), EQ, mesh, block_size=1024,
                               return_state=True)
    ref, zf = sosfilt(EQ, x, block_size=1024, return_zf=True)
    assert torch.equal(gather(y, mesh), ref) and torch.equal(st, zf)


def test_sosfilt_sharded_streams_bitwise_and_is_deterministic():
    """Super-blocks through the op, the state carried, equal one call at
    the same ``T_loc`` (a mesh with twice the time ranks) bit for bit:
    the composition is the same fixed-order sequence."""
    x = torch.from_numpy(_x(68, 4, 16 * 1024))
    mesh, wide = _cpu(1, 8), _cpu(1, 16)
    half = 8 * 1024
    y1, st = so.sosfilt_sharded(shard(x[:, :half], mesh), EQ, mesh,
                                block_size=1024, return_state=True)
    y2, st2 = so.sosfilt_sharded(shard(x[:, half:], mesh), EQ, mesh,
                                 block_size=1024, state=st,
                                 return_state=True)
    one, st_one = so.sosfilt_sharded(shard(x, wide), EQ, wide,
                                     block_size=1024, return_state=True)
    streamed = torch.cat([gather(y1, mesh), gather(y2, mesh)], dim=-1)
    assert torch.equal(streamed, gather(one, wide))
    assert torch.equal(st2, st_one)
    again = so.sosfilt_sharded(shard(x, wide), EQ, wide, block_size=1024)
    assert torch.equal(gather(again, wide), gather(one, wide))
    assert snr_db(sosfilt(EQ, x, block_size=1024).numpy(),
                  streamed.numpy()) >= IIR_DB


def test_sosfilt_sharded_matches_reference():
    x = _x(69, 4, 4 * 2048)
    rmesh = ref_mesh(1, 4, devices=jax.devices()[:4])
    xd = jax.device_put(jnp.asarray(x), NamedSharding(rmesh, P(RC, RT)))
    ref = np.asarray(rso.sosfilt_sharded(xd, EQ[:2], rmesh, block_size=1024,
                                         jitted=True))
    mesh = _cpu(1, 4)
    got = gather(so.sosfilt_sharded(shard(torch.from_numpy(x), mesh),
                                    EQ[:2], mesh, block_size=1024), mesh)
    assert snr_db(ref, got.numpy()) >= VS_REFERENCE_DB


def test_fft_frames_sharded_against_numpy_and_reference():
    x = _x(70, 8, 4 * 2048)
    mesh = _cpu(2, 4)
    got = gather(so.fft_frames_sharded(shard(torch.from_numpy(x), mesh),
                                       2048, mesh), mesh, dim=1).numpy()
    ref = np.fft.rfft(x.astype(np.float64).reshape(8, 4, 2048), axis=-1)
    assert got.shape == (8, 4, 1025)
    assert snr_db(ref.real, got.real) >= FFT_DB
    assert snr_db(ref.imag, got.imag) >= FFT_DB
    ref_j = _ref(rso.fft_frames_sharded, x, 256, window="hann")
    got_w = gather(so.fft_frames_sharded(shard(torch.from_numpy(x), mesh),
                                         256, mesh, window="hann"), mesh,
                   dim=1).numpy()
    assert got_w.shape == ref_j.shape
    assert snr_db(ref_j.real, got_w.real) >= VS_REFERENCE_DB
    assert snr_db(ref_j.imag, got_w.imag) >= VS_REFERENCE_DB


def test_plans_are_built_once_per_shape(monkeypatch):
    """``trace_counts`` counts the plans built: flat over repeated
    same-shape calls, as the JAX package's trace counters are under
    ``jitted=True``; ``jitted`` changes nothing else.  The calls run from
    their plan: the resampler's taps are designed once."""
    designs = []
    design = so._rs.resample_taps
    monkeypatch.setattr(so._rs, "resample_taps",
                        lambda *a, **k: designs.append(a) or design(*a, **k))
    mesh = _cpu(2, 4)
    x = shard(torch.from_numpy(_x(9, 4, 2 * 15360)), mesh)
    taps = rlz.firwin(64, 0.3)
    calls = {
        "fir": lambda j: so.fir_filter_sharded(x, taps, mesh,
                                               method="direct", jitted=j),
        "resample": lambda j: so.resample_sharded(
            x, 147, 160, mesh, taps_per_phase=8, jitted=j),
        "sosfilt": lambda j: so.sosfilt_sharded(x, EQ, mesh,
                                                block_size=1024, jitted=j),
        "fft_frames": lambda j: so.fft_frames_sharded(x, 64, mesh,
                                                      jitted=j),
    }
    for op, call in calls.items():
        first = call(False)
        n = so.trace_counts[op]
        again = call(True)
        call(True)
        assert so.trace_counts[op] == n, op
        assert all(torch.equal(a, b) for a, b in zip(first, again)), op
    assert designs == [(147, 160, 8)]
    n = so.trace_counts["fir"]
    so.fir_filter_sharded(shard(torch.zeros(4, 4 * 3840), mesh), taps, mesh,
                          method="direct")  # a new shape: a new plan
    assert so.trace_counts["fir"] == n + 1


def test_a_mesh_keeps_the_latest_plans():
    """The plans of a mesh are bounded as the JAX package's
    ``lru_cache(maxsize=64)``: the oldest goes first, and comes back as a
    new plan."""
    mesh = _cpu(1, 2)
    x = shard(torch.from_numpy(_x(10, 1, 2 * 64)), mesh)
    tap_sets = [np.full(4, 1.0 + i) for i in range(so.PLANS_KEPT + 1)]
    for taps in tap_sets:
        so.fir_filter_sharded(x, taps, mesh, method="direct")
    assert len(mesh.cache["sharded_ops"]) == so.PLANS_KEPT
    n = so.trace_counts["fir"]
    so.fir_filter_sharded(x, tap_sets[-1], mesh, method="direct")
    assert so.trace_counts["fir"] == n
    so.fir_filter_sharded(x, tap_sets[0], mesh, method="direct")
    assert so.trace_counts["fir"] == n + 1
