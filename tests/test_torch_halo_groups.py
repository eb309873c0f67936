"""How kernel B3's wrapper groups the ranks of a time mesh by card
(``ranks_by_card``, ``same_card_edges`` in
``llzlab_tpu_torch/kernels/halo_ring.py``): one launch per card, a direct
copy on an edge inside a card, the send / wait protocol on an edge between
cards.  Pure functions of a list of devices, so no card is needed."""

import pytest
import torch

from llzlab_tpu_torch.kernels import halo_ring as hr
from llzlab_tpu_torch.parallel import mesh as pmesh


def _cards(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize("indices,groups,same", [
    ((0, 0, 0, 0), [[0, 1, 2, 3]], [True, True, True]),
    ((0, 0, 1, 1), [[0, 1], [2, 3]], [True, False, True]),
    ((0, 1, 2, 3), [[0], [1], [2], [3]], [False, False, False]),
    ((2, 2, 2, 0), [[0, 1, 2], [3]], [True, True, False]),
    ((1,), [[0]], []),
])
def test_ranks_grouped_by_card_and_edges_classified(indices, groups, same):
    devices = _cards(*indices)
    assert hr.ranks_by_card(devices) == groups
    assert hr.same_card_edges(devices) == same
    # an edge is cross-card exactly where a group ends
    ends = {g[-1] for g in groups[:-1]}
    assert [r - 1 not in ends for r in range(1, len(indices))] == same


@pytest.mark.parametrize("indices", [(0, 1, 0, 1), (0, 0, 1, 0),
                                     (1, 0, 0, 1)])
def test_a_card_that_comes_back_raises(indices):
    with pytest.raises(ValueError, match="must be consecutive"):
        hr.ranks_by_card(_cards(*indices))


def test_device_specs_are_normalised():
    assert hr.ranks_by_card(["cuda:0", torch.device("cuda", 0), "cuda:1"]) \
        == [[0, 1], [2]]
    assert hr.ranks_by_card(["cpu"] * 3) == [[0, 1, 2]]
    assert hr.same_card_edges(["cuda:1", "cuda:1", "cuda:0"]) == [True, False]


@pytest.mark.parametrize("n", [1, 2, 16, 17, 40])
def test_a_card_with_many_ranks_takes_runs_of_at_most_16(n):
    """``HALO_MAX_RANKS`` entries fit one launch's table, and a card takes
    one launch: up to 16 ranks are one run, more raise."""
    assert hr.HALO_MAX_RANKS == 16
    if n > 16:
        with pytest.raises(ValueError, match="at most 16 ranks"):
            hr.ranks_by_card(_cards(*[0] * n))
        with pytest.raises(ValueError, match="at most 16 ranks"):
            hr.ranks_by_card(_cards(1, *[0] * n))
        return
    assert hr.ranks_by_card(_cards(*[0] * n)) == [list(range(n))]
    # a second card starts a run of its own
    assert hr.ranks_by_card(_cards(*[0] * n, 1, 1))[-1] == [n, n + 1]


def test_default_mesh_layout_is_groupable():
    """``make_dsp_mesh`` deals ranks out in equal contiguous runs: the
    layout for 8 ranks on 4 cards groups into 4 pairs."""
    devices = [torch.device("cuda", i * 4 // 8) for i in range(8)]
    assert hr.ranks_by_card(devices) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert hr.same_card_edges(devices) == [True, False] * 3 + [True]


def test_cpu_mesh_marks_nothing_and_cuda_wrapper_rejects_it():
    mesh = pmesh.DspMesh(["cpu"] * 2, (pmesh.TIME_AXIS,))
    mesh.fork()
    mesh.after(1, 0)
    mesh.join()  # no streams, no events: all three are no-ops
    assert all(r.stream is None for r in mesh.ranks)
    before = hr.left_halo_ring_cuda.launches
    with pytest.raises(ValueError, match="must lie on"):
        hr.left_halo_ring_cuda([torch.zeros(4, 16)] * 2, 4, mesh)
    assert hr.left_halo_ring_cuda.launches == before
