"""The port's heartbeat (the four cases of the JAX package's
``tests/test_health.py``, on CPU meshes) and ``collective_traffic``: the
bytes each exchange of ``parallel/`` moves, in the JAX package's kinds
and count, against the analytic models (the halo model of
``tests/parallel/test_collective_traffic.py``)."""

import numpy as np
import pytest
import torch

import llzlab_tpu as rlz
from llzlab_tpu.utils import profiling as rprof
from llzlab_tpu_torch import Channelizer
from llzlab_tpu_torch.parallel import sharded_ops as so
from llzlab_tpu_torch.parallel.mesh import (TIME_AXIS, DspMesh,
                                            make_dsp_mesh, shard)
from llzlab_tpu_torch.parallel.reshard import to_channel_major
from llzlab_tpu_torch.runtime.health import Heartbeat, heartbeat
from llzlab_tpu_torch.utils.profiling import collective_traffic


def _cpu(nc, nt):
    return make_dsp_mesh(nc, nt, devices=["cpu"] * (nc * nt))


class TestHeartbeat:
    def test_basic_ok(self):
        out = heartbeat(_cpu(2, 4))
        assert out["ok"] and out["devices"] == 8 and out["rtt_s"] >= 0

    def test_nan_payload_detected(self):
        bad = torch.full((8,), float("nan"))
        assert heartbeat(_cpu(2, 4), bad)["ok"] is False
        blocks = [torch.zeros(3)] * 7 + [torch.tensor([0.0, np.inf, 1.0])]
        assert heartbeat(_cpu(2, 4), blocks)["ok"] is False

    def test_every_n(self):
        hb = Heartbeat(_cpu(1, 8), every=3)
        results = [hb.tick() for _ in range(6)]
        assert [r is None for r in results] == [True, True, False] * 2

    def test_raises_on_nonfinite(self):
        hb = Heartbeat(_cpu(1, 8), every=1)
        with pytest.raises(FloatingPointError):
            hb.tick(torch.tensor([np.inf] * 8))


def test_the_dict_is_the_reference_shape_and_nothing_moved_is_zero():
    got = collective_traffic(lambda v: v * 2.0, torch.zeros(8, 8))
    assert got == {"total_bytes": 0, "ops": []}
    mesh = _cpu(2, 4)
    parts = shard(torch.zeros(8, 4 * 2048), mesh)
    assert collective_traffic(so.fft_frames_sharded, parts, 2048,
                              mesh)["total_bytes"] == 0
    # the JAX function's keys (it reads them from compiled HLO)
    assert set(rprof.collective_traffic("")) == set(got)


@pytest.mark.parametrize("method,shape", [("direct", (1, 4)),
                                          ("direct", (2, 2)),
                                          ("fused", (1, 4))])
def test_channelizer_halo_bytes_equal_the_analytic_model(method, shape):
    """Per channel row: (n_time − 1) halo sends of C_loc × (h_fir + h_rs)
    floats, and one copy of the row's state tail to rank 0 (the port keeps
    the state there, where the JAX package broadcasts it to every rank):
    n_time · C · (h_fir + h_rs) · 4 bytes for n_time > 1, all of them
    ``collective-permute``, no all-gather."""
    kw = dict(fir_taps=rlz.firwin(256, 0.4), fft_n=128, fir_method=method)
    kw.update(taps_per_phase=16) if method == "direct" else kw.update(
        up=3, down=4, taps_per_phase=8)
    chan = Channelizer(device="cpu", **kw)
    nc, nt = shape
    mesh = _cpu(nc, nt)
    c, t = 8, chan.block_multiple() * nt
    step = chan.sharded_step(mesh)
    r = collective_traffic(step, shard(torch.zeros(c, t), mesh),
                           chan.init_state(c))
    expect = nt * c * (chan.h_fir + chan.h_rs) * 4
    assert r["total_bytes"] == expect, r["ops"]
    assert {o["op"] for o in r["ops"]} == {"collective-permute"}
    ring = DspMesh(["cpu"] * 4, (TIME_AXIS,))
    r_rdma = collective_traffic(chan.sharded_step(ring, halo="rdma"),
                                shard(torch.zeros(c, 4 * chan.block_multiple()),
                                      ring), chan.init_state(c))
    assert r_rdma["total_bytes"] == 4 * c * (chan.h_fir + chan.h_rs) * 4


def test_all_to_all_and_sharded_op_bytes():
    mesh = _cpu(2, 4)
    x = torch.zeros(16, 4 * 512)
    a2a = collective_traffic(to_channel_major, shard(x, mesh), mesh)
    # per-device payload × participants over the groups: the whole array
    assert a2a["ops"] == [{"op": "all-to-all", "bytes": 16 * 2048 * 4,
                           "bytes_per_device": 16 * 2048 * 4 // 8}]
    taps = rlz.firwin(512, 0.25)
    fir = collective_traffic(so.fir_filter_sharded,
                             shard(torch.zeros(8, 4 * 3072), mesh), taps,
                             mesh)
    # the halo and the tail broadcast: 2 · rows · (n_time − 1) sends
    assert fir["total_bytes"] == 2 * 2 * 3 * 4 * 512 * 4
    eq = rlz.peaking_eq_sos([100, 1000], [3, -4], 48000.0)
    iir = collective_traffic(so.sosfilt_sharded,
                             shard(torch.zeros(8, 4 * 1024), mesh), eq, mesh,
                             block_size=256)
    # per section, the all-gather of (C_loc, 2) end states over time
    assert iir["ops"] == [{"op": "all-gather", "bytes": 8 * 8 * 4,
                           "bytes_per_device": 4 * 8}] * 2
    hb = collective_traffic(heartbeat, mesh)
    assert hb["ops"] == [{"op": "all-reduce", "bytes": 64,
                          "bytes_per_device": 8}]
