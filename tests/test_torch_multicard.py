"""The port on several cards of one machine: kernel B3's cross-card branch
and B4 with its neighbours on other cards, the channelizer's
``sharded_step`` on meshes over 2 and 4 cards in one process, the tool's
default mesh, four processes a card each over NCCL, and two processes a
card each as two hosts (``NET`` edges: NCCL on its network transport).  Every output is
held bit for bit against the same ranks on ``cuda:0`` (or, for the four
processes, against one process's 4-card mesh), at small widths.

Marked ``cuda`` and ``multicard``; each test skips without the cards it
needs (decided inside the test).  This file imports no JAX:

    python -m pytest --noconftest -m multicard tests/test_torch_multicard.py
"""

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.ops.fir import block2_block, firwin

pytestmark = [pytest.mark.cuda, pytest.mark.multicard]

#: the channelizer at the reference kernel tests' shapes
C, NTAPS, UP, DOWN, K, FFT = 16, 129, 3, 4, 8, 64


def _need(cards: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} NVIDIA GPUs "
                    f"({torch.cuda.device_count()} visible)")


def _mesh(cards, shape=None):
    from llzlab_tpu_torch.parallel.mesh import (TIME_AXIS, DspMesh,
                                                make_dsp_mesh)

    devs = [torch.device("cuda", i) for i in cards]
    if shape is None:
        return DspMesh(devs, (TIME_AXIS,))
    return make_dsp_mesh(*shape, devices=devs)


def _launch_counts(*wrappers):
    return [(w.launches, w.cross_card_launches) for w in wrappers]


@pytest.mark.parametrize("layout", [[0, 0, 1, 1], [0, 1, 2, 3],
                                    [0, 0, 0, 0, 1, 1, 1, 1]])
@pytest.mark.parametrize("h", [63, 1024])
def test_halo_ring_across_cards_is_one_card_and_plain(layout, h):
    """B3 on a 1-D mesh whose edges are on one card or across cards, over
    three epochs with a carry: bitwise the same ranks on ``cuda:0`` and
    the plain version; one launch a card, each card's launch across."""
    _need(max(layout) + 1)
    from llzlab_tpu_torch.kernels import halo_ring as hr

    n = len(layout)
    rng = np.random.default_rng(50)
    x = rng.standard_normal((C, n * 2048)).astype(np.float32)
    carry = torch.from_numpy(rng.standard_normal((C, h)).astype(np.float32))
    runs = {}
    for name, cards in (("multi", layout), ("one", [0] * n)):
        mesh = _mesh(cards)
        parts = [torch.from_numpy(x[:, r * 2048:(r + 1) * 2048]).to(
            mesh.ranks[r].device) for r in range(n)]
        before = _launch_counts(hr.left_halo_ring_cuda)[0]
        for _ in range(3):
            mesh.fork()
            got = hr.left_halo_ring(parts, h, mesh,
                                    first_shard_value=carry.cuda())
            mesh.join()
        hr.check_exchanges(mesh)
        after = _launch_counts(hr.left_halo_ring_cuda)[0]
        runs[name] = ([v.cpu() for v in got],
                      (after[0] - before[0], after[1] - before[1]))
        plain = hr.left_halo_ring_plain(parts, h, mesh,
                                        first_shard_value=carry.cuda())
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    for a, b in zip(runs["multi"][0], runs["one"][0]):
        assert torch.equal(a, b)
    n_cards = len(set(layout))
    assert runs["multi"][1] == (3 * n_cards, 3 * n_cards)
    assert runs["one"][1] == (3, 0)


@pytest.mark.parametrize("mode", ["high", "highest"])
@pytest.mark.parametrize("cards", [2, 4])
def test_halo_fir_fused_one_rank_a_card(cards, mode):
    """B4 with its neighbours on other cards, three epochs (no carry, then
    a block of carry twice): bitwise the same ranks on ``cuda:0`` and
    kernel B2 on the unsharded stream."""
    _need(cards)
    from llzlab_tpu_torch.kernels import block2_fir as bf
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr

    taps = firwin(1024, 0.4)
    block = block2_block(1024)
    t_loc = 4 * block
    rng = np.random.default_rng(51)
    x = torch.from_numpy(
        rng.standard_normal((32, cards * t_loc)).astype(np.float32))
    outs = {}
    for name, layout in (("multi", list(range(cards))), ("one", [0] * cards)):
        mesh = _mesh(layout)
        parts = [x[:, r * t_loc:(r + 1) * t_loc].contiguous().to(
            mesh.ranks[r].device) for r in range(cards)]
        carry, got_all = None, []
        before = _launch_counts(hf.block2_fir_halo_fused_cuda)[0]
        for _ in range(3):
            mesh.fork()
            got = hf.block2_fir_halo_fused(
                parts, taps, mesh, mode=mode,
                first_shard_value=None if carry is None else carry.to(
                    mesh.ranks[0].device))
            mesh.join()
            hr.check_exchanges(mesh)
            got_all.append(torch.cat([v.cpu() for v in got], -1))
            carry = x[:, -block:].contiguous()
        after = _launch_counts(hf.block2_fir_halo_fused_cuda)[0]
        outs[name] = (got_all, after[1] - before[1])
    for a, b in zip(outs["multi"][0], outs["one"][0]):
        assert torch.equal(a, b)
    assert outs["multi"][1] == 3 * cards and outs["one"][1] == 0
    lead = torch.zeros((32, block))
    whole = bf.block2_fir_cuda(torch.cat([lead, x], -1).cuda(), taps, block,
                               mode)
    assert torch.equal(outs["multi"][0][0], whole.cpu())


#: (fir_method, halo, frames, halo_overlap) on 1-D meshes over the cards
STEP_MODES = [
    ("fused", "ppermute", "local", False), ("fused", "rdma", "local", False),
    ("fused", "rdma", "a2a", False), ("fused", "rdma", "local", True),
    ("block2", "ppermute", "local", False), ("block2", "rdma", "local", False),
    ("block2", "rdma_fused", "local", False),
    ("block2", "rdma_fused", "a2a", False),
    ("block2", "ppermute", "a2a", False), ("block2", "rdma", "local", True),
]


def _steps(method, halo, frames, overlap, mesh, x, t_step):
    """Two steps of ``sharded_step`` on ``mesh`` from a zero state, each of
    ``t_step`` samples of ``x``: each step's rank outputs and the final
    state, on the host."""
    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.kernels.halo_ring import check_exchanges
    from llzlab_tpu_torch.parallel.mesh import shard

    dev = mesh.ranks[0].device
    ch = Channelizer(fir_taps=firwin(NTAPS, 0.2), up=UP, down=DOWN,
                     taps_per_phase=K, fft_n=FFT, fir_method=method,
                     device=dev)
    step = ch.sharded_step(mesh, halo=halo, frames=frames,
                           halo_overlap=overlap)
    st = ch.init_state(C)
    out = []
    for i in range(2):
        parts = shard(torch.from_numpy(
            x[:, i * t_step:(i + 1) * t_step]).to(dev), mesh)
        spec, st = step(parts, st)
        out.append([v.cpu() for v in spec])
    check_exchanges(mesh)
    return out, [v.cpu() for v in st]


@pytest.mark.parametrize("method,halo,frames,overlap", STEP_MODES)
@pytest.mark.parametrize("cards", [2, 4])
def test_sharded_step_across_cards_is_one_card(cards, method, halo, frames,
                                               overlap):
    _need(cards)
    from llzlab_tpu_torch.kernels import halo_fir_fused as hf
    from llzlab_tpu_torch.kernels import halo_ring as hr

    t_loc = 640 if frames == "a2a" and method == "block2" else 1024
    x = np.random.default_rng(52).standard_normal(
        (C, 2 * cards * t_loc)).astype(np.float32)
    before = _launch_counts(hr.left_halo_ring_cuda,
                            hf.block2_fir_halo_fused_cuda)
    multi = _steps(method, halo, frames, overlap, _mesh(range(cards)), x,
                   cards * t_loc)
    after = _launch_counts(hr.left_halo_ring_cuda,
                           hf.block2_fir_halo_fused_cuda)
    one = _steps(method, halo, frames, overlap, _mesh([0] * cards), x,
                 cards * t_loc)
    for a, b in zip(multi[0] + [multi[1]], one[0] + [one[1]]):
        for u, v in zip(a, b):
            assert u.shape == v.shape and torch.equal(u, v)
    crossed = [a[1] - b[1] for a, b in zip(after, before)]
    assert crossed[0] > 0 if halo != "ppermute" else crossed == [0, 0]
    if halo == "rdma_fused":
        assert crossed[1] == 2 * cards


@pytest.mark.parametrize("mode", ["highest", "high"])
@pytest.mark.parametrize("cards", [2, 4])
def test_rdma_step_at_the_cell_shape_is_one_card_and_unsharded(cards, mode):
    """The step that the four-card benchmark cell runs, ``fused`` with
    ``halo="rdma"`` a rank a card, at its filter (1024 taps, 147/160, K =
    64) on 8 channels, where B1 takes its wgmma path at both precisions:
    over two steps with the state carried, bitwise the same ranks on
    ``cuda:0`` and the unsharded ``Channelizer.step`` streamed over the same
    samples a rank's block at a time (so B1's windows hold their bits at a
    time shard's edge, across cards; one unsharded call of all the ranks'
    samples frames them in one cuFFT plan of another batch, whose bits
    differ); every B1 launch of the cards' run a wgmma launch."""
    _need(cards)
    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.kernels import fused_fir_resample as ff
    from llzlab_tpu_torch.kernels.halo_ring import check_exchanges
    from llzlab_tpu_torch.parallel.mesh import gather, shard
    from llzlab_tpu_torch.runtime.platform import precision_scope

    c = 8
    ch = Channelizer(fir_taps=firwin(1024, 0.4, window="hamming"), up=147,
                     down=160, taps_per_phase=64, fft_n=2048,
                     fir_method="fused", device=torch.device("cuda", 0))
    assert ff.wgmma_fits(1024, ch.up, ch.down, ch.k, mode)
    t_loc = ch.block_multiple()
    t_step = cards * t_loc
    x = torch.from_numpy(np.random.default_rng(54).standard_normal(
        (c, 2 * t_step)).astype(np.float32)).cuda()
    counts = ("launches", "wgmma_launches", "wgmma_highest_launches")

    def run(mesh):
        step = ch.sharded_step(mesh, halo="rdma")
        st, out = ch.init_state(c), []
        for i in range(2):
            spec, st = step(shard(x[:, i * t_step:(i + 1) * t_step], mesh),
                            st)
            out.append(gather(spec, mesh, dim=1).cpu())
        check_exchanges(mesh)
        return out, [v.cpu() for v in st]

    with precision_scope(mode):
        before = [getattr(ff.fused_fir_resample_cuda, a) for a in counts]
        multi = run(_mesh(range(cards)))
        after = [getattr(ff.fused_fir_resample_cuda, a) for a in counts]
        one = run(_mesh([0] * cards))
        st, ref = ch.init_state(c), []
        for i in range(2):
            blocks = []
            for r in range(cards):
                s0 = i * t_step + r * t_loc
                spec, st = ch.step(x[:, s0:s0 + t_loc], st)
                blocks.append(spec)
            ref.append(torch.cat(blocks, dim=1).cpu())
        unsharded = ref, [v.cpu() for v in st]
    launched = [a - b for a, b in zip(after, before)]
    assert launched == [2 * cards, 2 * cards,
                        2 * cards * (mode == "highest")]
    for what, other in (("the same ranks on cuda:0", one),
                        ("the unsharded stream", unsharded)):
        for a, b in zip(multi[0] + multi[1], other[0] + other[1]):
            assert a.shape == b.shape and torch.equal(a, b), what


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("method,frames", [("fused", "local"),
                                           ("block2", "a2a"),
                                           ("block2", "local")])
def test_sharded_step_on_2d_meshes_of_four_cards(shape, method, frames):
    _need(4)
    t_loc = 640 if frames == "a2a" else 1024
    t_step = shape[1] * t_loc  # T_loc a rank
    x = np.random.default_rng(53).standard_normal(
        (C, 2 * t_step)).astype(np.float32)
    multi = _steps(method, "ppermute", frames, False,
                   _mesh(range(4), shape), x, t_step)
    one = _steps(method, "ppermute", frames, False, _mesh([0] * 4, shape),
                 x, t_step)
    for a, b in zip(multi[0] + [multi[1]], one[0] + [one[1]]):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_the_tool_default_mesh_on_the_cards(tmp_path):
    """The channelizer tool with no mesh options: one rank a card, against
    ``Channelizer.step`` on the whole input (140 dB, as ``chip_smoke.py``
    holds the tool on one card)."""
    _need(2)
    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.cli import channelizer as cz_cli

    count = torch.cuda.device_count()
    out = str(tmp_path / "spec.npz")
    ch = Channelizer(fir_taps=firwin(NTAPS, 0.4, window="hamming"),
                     fft_n=FFT, fir_method="ols", device="cuda")
    m = ch.block_multiple() * count
    seconds = (2 * m + 10) / 48000  # the tool keeps 2 m samples
    cz_cli.main(["-o", out, "--synth", "4", "--seconds", str(seconds),
                 "--fir-taps", str(NTAPS), "--fft", str(FFT)])
    with np.load(out) as z:
        spec = z["spectra"]
    x = np.random.default_rng(0).standard_normal(
        (4, int(seconds * 48000))).astype(np.float32)[:, :2 * m]
    ref, _ = ch.step(torch.from_numpy(x).cuda(), ch.init_state(4))
    ref = ref.cpu().numpy()
    err = np.sum(np.abs(ref - spec) ** 2)
    assert spec.shape == ref.shape
    assert err == 0 or 10 * np.log10(np.sum(np.abs(ref) ** 2) / err) >= 140


def test_four_processes_over_nccl_are_the_four_card_mesh(tmp_path):
    """Four processes, a card each, over NCCL: the halo, the state tail,
    the reshard, the IIR carry and two channelizer steps (``ppermute``,
    frames local and ``a2a``; ``rdma`` and ``rdma_fused``, kernels B3 and
    B4 between the processes through CUDA IPC) give each rank what one
    process's mesh of the four cards gives it, and every process the same
    state; so do B3 and B4 called directly and the tap-parallel FIR."""
    _need(4)
    from tests.test_torch_distributed import (_launch, _same_as_one_process,
                                              channelizer_same_as_one_process,
                                              kernels_same_as_one_process)
    from tests.torch_dist_worker import CZ_KERNEL_RUNS

    out = _launch(tmp_path, "cuda", n_procs=4)
    cards = [torch.device("cuda", i) for i in range(4)]
    _same_as_one_process(out, "cuda")
    channelizer_same_as_one_process(out, cards, 4)
    channelizer_same_as_one_process(out, cards, 4, CZ_KERNEL_RUNS)
    kernels_same_as_one_process(out, cards)


def test_two_processes_as_two_hosts_are_one_process_mesh(tmp_path):
    """The ``hosts`` mode of ``scripts/halo_ipc_worker_torch.py`` on two
    cards, small: each process a host of its own, so both edges are
    ``NET`` edges, NCCL without its peer-to-peer and shared-memory
    transports (its log names a network one); the channelizer's ``rdma``
    and ``rdma_fused`` steps and each process's state are bitwise the same
    steps of one process's mesh over the two cards, B3 and B4 launched
    across the hosts, and the traffic is the model's."""
    _need(2)
    from llzlab_tpu_torch import Channelizer
    from llzlab_tpu_torch.kernels import halo_ring as hr
    from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh
    from scripts import halo_ipc_worker_torch as hw

    channels, t_loc = 256, 327680
    res = hw.launch("hosts", 2, str(tmp_path), [
        "--channels", str(channels), "--t-loc", str(t_loc), "--iters", "2"])
    mesh = DspMesh([torch.device("cuda", i) for i in range(2)],
                   (TIME_AXIS,))
    for r in res:
        assert r["kinds"] == [hr.NET]
        assert r["nccl_transport"] and all(
            v.startswith("NET/") for v in r["nccl_transport"])
    for method, halo, _ in hw.CZ_PATHS:
        c = min(channels, hw.CZ_FUSED_CHANNELS) if halo == "rdma_fused" \
            else channels
        path = f"config 5 {method} {halo} {c}ch 1x2 processes"
        want = hw.cz_steps(Channelizer(fir_method=method, device="cuda:0"),
                           mesh, c, t_loc, halo)
        for r in res:
            for k, v in r["digests"][path].items():
                assert want[k] == v, (path, r["process"], k)
            moved, model = r["traffic"][path]
            assert moved == model
        counts = [r["paths"][path] for r in res]
        assert all(n[1] > 0 for n in (counts[0]["halo_ring"],
                                      counts[1]["halo_ring"]))
