"""The port's tap-parallel FIR and stage pipeline on CPU meshes, against
the port's unsharded ops and against the JAX package's
``fir_filter_tap_parallel`` and ``stage_pipeline`` under ``shard_map`` on
the CPU device mesh, at the shapes of its own tests
(``tests/parallel/test_tp_pp.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import llzlab_tpu as rlz
from llzlab_tpu.parallel.mesh import make_dsp_mesh as ref_mesh
from llzlab_tpu.parallel.stage_pp import make_stage_mesh as ref_stage_mesh
from llzlab_tpu.parallel.stage_pp import stage_pipeline as ref_pipeline
from llzlab_tpu.parallel.tap_tp import fir_filter_tap_parallel as ref_tap
from llzlab_tpu_torch.ops.fir import fir_filter
from llzlab_tpu_torch.parallel.mesh import make_dsp_mesh
from llzlab_tpu_torch.parallel.stage_pp import (STAGE_AXIS, make_stage_mesh,
                                                stage_pipeline)
from llzlab_tpu_torch.parallel.tap_tp import fir_filter_tap_parallel
from tests.conftest import snr_db

#: the tap-parallel FIR against fir_filter; the pipeline against the JAX
#: one (tests/parallel/test_tp_pp.py:20,76); the port against the JAX
#: package
TAP_DB, PIPE_VS_REF_DB, VS_REFERENCE_DB = 120.0, 85.0, 120.0


def _x(seed, c, t):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(
        np.float32)


@pytest.mark.parametrize("ntaps,cutoff,c,t,seed", [
    (1024, 0.25, 4, 8192, 151), (1000, 0.3, 2, 4096, 152)])  # 1000 % 8 != 0
def test_tap_parallel_matches_fir_filter(ntaps, cutoff, c, t, seed):
    taps = rlz.firwin(ntaps, cutoff)
    x = _x(seed, c, t)
    mesh = make_dsp_mesh(1, 8, devices=["cpu"] * 8)
    got = fir_filter_tap_parallel(torch.from_numpy(x), taps, mesh)
    ref = fir_filter(torch.from_numpy(x), taps, method="direct").numpy()
    assert len(got) == 8
    assert all(torch.equal(g, got[0]) for g in got)  # replicated
    assert snr_db(ref, got[0].numpy()) >= TAP_DB


def test_tap_parallel_matches_reference_and_runs_per_channel_row():
    taps = rlz.firwin(1000, 0.3)
    x = _x(153, 2, 4096)
    ref = np.asarray(ref_tap(jnp.asarray(x), taps, ref_mesh(2, 4)))
    mesh = make_dsp_mesh(2, 4, devices=["cpu"] * 8)
    got = fir_filter_tap_parallel(torch.from_numpy(x), taps, mesh)
    assert snr_db(ref, got[0].numpy()) >= VS_REFERENCE_DB
    assert all(torch.equal(g, got[0]) for g in got)


FNS = [lambda v: v * 0.5, lambda v: v + 0.25, torch.tanh, lambda v: v * 2.0]


def test_pipeline_is_the_serial_composition_bitwise():
    mesh = make_stage_mesh(4, devices=["cpu"] * 4)
    assert mesh.axis_names == (STAGE_AXIS,)
    x = torch.from_numpy(_x(153, 4, 8 * 512))
    y = stage_pipeline(FNS, mesh, x, micro_block=512)
    blocks = []
    for i in range(8):
        v = x[:, i * 512:(i + 1) * 512]
        for f in FNS:
            v = f(v)
        blocks.append(v)
    assert torch.equal(y, torch.cat(blocks, dim=-1))


def test_two_filter_stages_match_serial_and_reference():
    """Blockwise stateless FIR stages (short taps, a zero history each
    block): bitwise the port's serial blockwise composition, and the JAX
    pipeline at its own floor."""
    taps_a = rlz.firwin(33, 0.4)
    taps_b = rlz.firwin(17, 0.6, pass_zero=False)
    x = _x(154, 2, 6 * 1024)

    def fa(v):
        return fir_filter(v, taps_a, method="direct")

    def fb(v):
        return fir_filter(v, taps_b, method="direct")

    y = stage_pipeline([fa, fb], make_stage_mesh(2, devices=["cpu"] * 2),
                       torch.from_numpy(x), micro_block=1024)
    serial = torch.cat([fb(fa(torch.from_numpy(x[:, i * 1024:
                                                  (i + 1) * 1024])))
                        for i in range(6)], dim=-1)
    assert torch.equal(y, serial)

    def ra(v):
        return rlz.fir_filter(v, taps_a, method="direct")

    def rb(v):
        return rlz.fir_filter(v, taps_b, method="direct")

    ref = np.asarray(ref_pipeline([ra, rb], ref_stage_mesh(2),
                                  jnp.asarray(x), micro_block=1024))
    assert snr_db(ref, y.numpy()) >= PIPE_VS_REF_DB


def test_pipeline_rejects_what_the_reference_rejects():
    mesh = make_stage_mesh(4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="number of stages"):
        stage_pipeline(FNS[:3], mesh, torch.zeros(2, 1024), micro_block=512)
    with pytest.raises(ValueError, match="multiple of micro_block"):
        stage_pipeline(FNS, mesh, torch.zeros(2, 1000), micro_block=512)
    with pytest.raises(ValueError, match="need 4 devices"):
        make_stage_mesh(4, devices=["cpu"] * 3)
