"""How the port deals ranks onto several cards, on the CPU: plain device
lists, no stream made.  ``parallel.mesh.deal_devices`` for 1 to 4 cards
and the meshes of the multi-card runs; kernel B3's grouping of every dealt
row by card (``ranks_by_card``) and its same-card edges; the channelizer
tool's mesh against ``make_dsp_mesh``'s; the mesh's per-process first
ranks; the refusals of peer access that the halo kernels need between
cards, and that PyTorch's expandable segments no longer refuse it; and the
kind of each edge by process, card and host (a ``NET`` edge between hosts,
which raises on a group that is not NCCL's)."""

import pytest
import torch

from llzlab_tpu_torch.cli import channelizer as cz_cli
from llzlab_tpu_torch.kernels import halo_ring as hr
from llzlab_tpu_torch.parallel import mesh as pm
from llzlab_tpu_torch.parallel.mesh import TIME_AXIS, DspMesh, deal_devices

#: the (n_channel, n_time) meshes of the multi-card runs
MESHES = ((1, 4), (2, 2), (4, 1), (1, 8))


def _cards(devs):
    return [d.index for d in devs]


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_deal_devices_one_rank_a_card_else_consecutive_runs(n, count):
    cards = _cards(deal_devices(n, count))
    assert len(cards) == n
    assert all(d.type == "cuda" for d in deal_devices(n, count))
    if n <= count:
        assert cards == list(range(n))  # one rank a card, the first n
    else:
        assert sorted(set(cards)) == list(range(count))  # every card used
        sizes = [cards.count(c) for c in range(count)]
        assert max(sizes) - min(sizes) <= 1  # equal runs
    assert cards == sorted(cards)  # a card's ranks are consecutive


@pytest.mark.parametrize("count,want", [
    (1, {(1, 4): [0, 0, 0, 0], (2, 2): [0, 0, 0, 0], (4, 1): [0, 0, 0, 0],
         (1, 8): [0] * 8}),
    (2, {(1, 4): [0, 0, 1, 1], (2, 2): [0, 0, 1, 1], (4, 1): [0, 0, 1, 1],
         (1, 8): [0, 0, 0, 0, 1, 1, 1, 1]}),
    (4, {(1, 4): [0, 1, 2, 3], (2, 2): [0, 1, 2, 3], (4, 1): [0, 1, 2, 3],
         (1, 8): [0, 0, 1, 1, 2, 2, 3, 3]}),
])
def test_deal_devices_on_the_multicard_meshes(count, want):
    for (nc, nt), cards in want.items():
        assert _cards(deal_devices(nc * nt, count)) == cards


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", MESHES)
def test_ranks_by_card_takes_every_dealt_row(shape, count):
    nc, nt = shape
    devs = deal_devices(nc * nt, count)
    for c in range(nc):
        row = devs[c * nt:(c + 1) * nt]
        groups = hr.ranks_by_card(row)
        assert [r for g in groups for r in g] == list(range(nt))
        assert all(len({row[r] for r in g}) == 1 for g in groups)
        edges = hr.same_card_edges(row)
        assert edges == [row[r - 1] == row[r] for r in range(1, nt)]
        # B3 runs the send / wait protocol on as many edges as the row
        # has cards, less one
        assert edges.count(False) == len(groups) - 1


@pytest.mark.parametrize("layout,edges", [
    ([0, 0, 1, 1], [True, False, True]),
    ([0, 1, 2, 3], [False, False, False]),
    ([0, 0, 0, 0, 1, 1, 1, 1], [True, True, True, False, True, True, True]),
])
def test_same_card_edges_of_the_b3_layouts(layout, edges):
    devs = [torch.device("cuda", i) for i in layout]
    assert hr.same_card_edges(devs) == edges
    assert [len(g) for g in hr.ranks_by_card(devs)] == \
        [layout.count(i) for i in sorted(set(layout))]


def test_ranks_by_card_refuses_a_card_that_comes_back():
    devs = [torch.device("cuda", i) for i in (0, 1, 0)]
    with pytest.raises(ValueError, match="consecutive"):
        hr.ranks_by_card(devs)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("opts", [(None, None), (2, None), (None, 4),
                                  (2, 2), (4, 1), (1, 8)])
def test_the_tool_mesh_is_make_dsp_mesh(opts, count, monkeypatch):
    """The tool's default mesh is one rank a card; whatever its options,
    its ranks are those ``make_dsp_mesh`` deals for its shape."""
    seen = []
    monkeypatch.setattr(pm, "require_cuda", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(pm, "DspMesh", lambda devs, axes, shape: seen.append(
        (list(devs), shape)))
    nc, nt = cz_cli.mesh_shape(*opts, count)
    if opts == (None, None):
        assert (nc, nt) == (1, count)
    pm.make_dsp_mesh(nc, nt)
    assert seen == [(deal_devices(nc * nt, count), (nc, nt))]


def test_homes_of_a_mesh_are_each_process_first_rank():
    assert DspMesh(["cpu"] * 4, (TIME_AXIS,)).homes == [0]
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,), processes=[0, 0, 1, 1])
    assert mesh.homes == [0, 2] and mesh.home == 0
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,), processes=[0, 1, 2, 3])
    assert mesh.homes == [0, 1, 2, 3]


def test_fork_join_synchronize_on_a_cpu_mesh_do_nothing():
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,))
    mesh.fork()
    mesh.join()
    mesh.synchronize()


def test_a_pair_of_cards_without_peer_access_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: not (a == 1 and b == 0))
    with pytest.raises(RuntimeError, match="no peer access from cuda:1"):
        hr.enable_peer_access(torch.device("cuda", 0),
                              torch.device("cuda", 1))


class _PeerLib:
    """The build's C library as far as ``enable_peer_access`` calls it:
    each direction's ``cudaDeviceEnablePeerAccess`` is recorded and
    answers 0 (enabled now), or -1 (already enabled) the second time."""

    def __init__(self):
        self.calls = []

    def halo_enable_peer_access(self, src, dst):
        self.calls.append((src, dst))
        return -1 if self.calls.count((src, dst)) > 1 else 0


@pytest.mark.parametrize("var", ["PYTORCH_CUDA_ALLOC_CONF",
                                 "PYTORCH_ALLOC_CONF"])
def test_peer_access_refuses_expandable_segments(var, monkeypatch):
    """The name is the old behaviour's.  Under PyTorch's expandable
    segments peer access is enabled as under the default allocator, in
    both directions: what a peer card stores into is the exchange's own
    ``cudaMalloc``, never the allocator's memory."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    monkeypatch.setenv(var, "max_split_size_mb:64, expandable_segments:True")
    lib = _PeerLib()
    monkeypatch.setattr(hr._build, "load", lambda name, declare: lib)
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    assert hr.enable_peer_access(a, b) == [0, 0]
    assert hr.enable_peer_access(b, a) == [-1, -1]
    assert lib.calls == [(0, 1), (1, 0), (1, 0), (0, 1)]


def _places(layout):
    return [(p, torch.device("cuda", d)) for p, d in layout]


D, P, X, N = hr.DIRECT, hr.PROTOCOL, hr.PROCESS, hr.NET


@pytest.mark.parametrize("layout,kinds,runs", [
    # two processes on one card, two ranks each
    ([(0, 0), (0, 0), (1, 0), (1, 0)], [D, X, D], {0: [[0, 1]], 1: [[2, 3]]}),
    # a process a card, each seeing its card as cuda:0 ...
    ([(p, 0) for p in range(4)], [X, X, X], {p: [[p]] for p in range(4)}),
    # ... or every card
    ([(p, p) for p in range(4)], [X, X, X], {p: [[p]] for p in range(4)}),
    # two processes of two cards each
    ([(0, 0), (0, 1), (1, 0), (1, 1)], [P, X, P], {0: [[0], [1]],
                                                   1: [[2], [3]]}),
])
def test_edge_plan_by_process_and_card(layout, kinds, runs):
    """Each edge copies directly (one process, one card), runs the protocol
    within a process (two cards), or crosses processes (CUDA IPC); each
    process launches its own runs of ranks only.  Launched each rank
    alone, no edge copies directly and every run is one rank."""
    places = _places(layout)
    for me, want in runs.items():
        got_runs, got_kinds = hr.edge_plan(places, me)
        assert got_kinds == kinds and got_runs == want
        alone, alone_kinds = hr.edge_plan(places, me, per_rank=True)
        assert alone == [[r] for run in want for r in run]
        assert alone_kinds == [P if k == D else k for k in kinds]
    assert hr.edge_plan(places, 9) == ([], kinds)  # a process of no rank


@pytest.mark.parametrize("layout,hosts,kinds", [
    # two processes of two ranks each, on two hosts
    ([(0, 0), (0, 0), (1, 0), (1, 0)], "aabb", [D, N, D]),
    # ... on one host
    ([(0, 0), (0, 0), (1, 0), (1, 0)], "aaaa", [D, X, D]),
    # a process a card, two processes a host
    ([(p, 0) for p in range(4)], "aabb", [X, N, X]),
    # a process a card, a host each
    ([(p, 0) for p in range(4)], "abcd", [N, N, N]),
    # two processes of two cards each, a host each
    ([(0, 0), (0, 1), (1, 0), (1, 1)], "aabb", [P, N, P]),
])
def test_edge_plan_by_host(layout, hosts, kinds):
    """An edge between processes on two hosts is a ``NET`` edge, on one
    host a ``PROCESS`` edge; within a process the host changes nothing.
    The runs each process launches do not depend on the hosts."""
    places = _places(layout)
    for me in (0, 1):
        runs, got = hr.edge_plan(places, me, hosts=list(hosts))
        assert got == kinds
        assert runs == hr.edge_plan(places, me)[0]
        alone = hr.edge_plan(places, me, per_rank=True, hosts=list(hosts))
        assert alone[1] == [P if k == D else k for k in kinds]


def test_edge_plan_of_a_mesh_across_processes_and_its_refusals():
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,), processes=[0, 0, 1, 1])
    assert hr.mesh_plan(mesh) == ([[0, 1]], [D, X, D])
    # a card of one process comes back after another process's ranks
    with pytest.raises(ValueError, match="consecutive"):
        hr.edge_plan(_places([(0, 0), (1, 0), (0, 0)]), 0)
    # the same card in two processes is two runs
    assert hr.edge_plan(_places([(0, 0), (1, 0)]), 1) == ([[1]], [X])


def test_an_edge_across_hosts_raises_naming_ppermute(monkeypatch):
    """The name is the old behaviour's.  An edge between two hosts is a
    ``NET`` edge, whose bytes travel through NCCL: the halo exchange of a
    mesh with one raises, naming NCCL, where the process group is not
    NCCL's (here: none), before it allocates anything; the same mesh on
    one host plans ``PROCESS`` edges."""
    mesh = DspMesh(["cpu"] * 4, (TIME_AXIS,), processes=[0, 0, 1, 1])
    assert hr.mesh_plan(mesh)[1] == [D, X, D]  # no group: one host
    monkeypatch.setattr(hr, "process_hosts", lambda m: ["a", "a", "b", "b"])
    assert hr.mesh_plan(mesh) == ([[0, 1]], [D, N, D])
    with pytest.raises(RuntimeError, match="NCCL") as err:
        hr.HaloExchange(mesh, 8, 63)
    assert "(1, 2)" in str(err.value) and "gloo" in str(err.value)
    hr.check_net_group([D, X, D])  # no NET edge: any group will do
    with pytest.raises(RuntimeError, match="no process group"):
        hr.check_net_group([D, N, D])
