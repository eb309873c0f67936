"""The scan kernel's arithmetic on the CPU (``kernels/sos_scan.py``): its
plain version, in the kernel's block-major order and reading the kernel's
packed tables, is bit for bit ``sosfilt``'s tensor code (outputs and
states); the packed tables are ``_scan_tables_host``'s entries; a CPU
tensor never reaches the kernel's wrapper; and the wrapper raises on what
the kernel does not take, before anything is built.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from llzlab_tpu_torch.kernels import _build
from llzlab_tpu_torch.kernels import sos_scan
from llzlab_tpu_torch.ops import iir

EQ = iir.peaking_eq_sos([100, 200, 400, 800, 1600, 3200, 6400, 12800],
                        [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)
#: odd order: one real-pole section (the companion form)
BUTTER7 = iir.butter_sos(7, 0.3)
DESIGNS = {"eq": EQ, "butter7": BUTTER7}


def _inputs(sos, rows, t, nonzero_zi, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, t)).astype(np.float32))
    zi = (torch.from_numpy(rng.standard_normal(
        (rows, len(sos), 2)).astype(np.float32)) if nonzero_zi else None)
    return x, zi


@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("block", [1024, 4096])
@pytest.mark.parametrize("blocks,extra", [(0, 0), (0, 300), (1, 0), (6, 300)])
@pytest.mark.parametrize("nonzero_zi", [False, True])
def test_the_kernels_plain_version_is_bitwise_the_tensor_scan(
        design, block, blocks, extra, nonzero_zi):
    sos = DESIGNS[design]
    t = blocks * block + extra
    x, zi = _inputs(sos, 3, t, nonzero_zi)
    y, zf = iir.sosfilt(sos, x, zi=zi, block_size=block, return_zf=True)
    yp, zfp = sos_scan.sos_scan_plain(x, sos_scan.scan_tables(sos, block),
                                      zi, return_zf=True)
    assert yp.shape == y.shape == (3, t) and zfp.shape == zf.shape
    assert torch.equal(yp, y)
    assert torch.equal(zfp, zf)


@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("block", [1, 1000, 4096])
def test_the_packed_tables_are_the_scan_tables(design, block):
    sos = DESIGNS[design]
    tables = sos_scan.scan_tables(sos, block)
    kinds, params = iir.sos_plan(sos)
    assert tables.ns == len(kinds) and tables.block_size == block
    assert tables.buf.dtype == torch.float32
    assert tables.buf.shape == (len(kinds),
                                sos_scan.table_stride(block, tables.nsh))
    for s, (kind, p) in enumerate(zip(kinds, params)):
        host = iir._scan_tables_host(kind, tuple(float(v) for v in p), block)
        assert tables.nsh == len(host["shifts"])
        row = tables.buf[s].numpy()
        h, n = sos_scan.HEAD, 4 * tables.nsh
        np.testing.assert_array_equal(row[:2], host["u"])
        np.testing.assert_array_equal(row[2:4], np.float32(host["c"]))
        assert row[4] == np.float32(host["b0"]) and not row[5:h].any()
        np.testing.assert_array_equal(row[h:h + n].reshape(-1, 2, 2),
                                      host["steps"])
        np.testing.assert_array_equal(
            row[h + n:h + n + 2 * block].reshape(block, 2), host["g"])
        np.testing.assert_array_equal(
            row[h + n + 2 * block:].reshape(block, 2, 2), host["carry"])


#: (design, sections repeated, block) -> whether the wide variant runs it
WIDE = {("eq", 1, 1024): False, ("eq", 1, 8192): False,
        ("eq", 1, 8193): True, ("butter7", 1, 65536): True,
        ("eq", 50, 4096): False, ("eq", 200, 1024): True}


@pytest.mark.parametrize("design,repeat,block", sorted(WIDE))
def test_the_wide_variant_takes_what_shared_memory_does_not_hold(
        design, repeat, block):
    """Blocks above ``MAX_BLOCK``, or a cascade whose buffers, states and
    heads overflow shared memory, take the wide variant
    (``csrc/sos_scan.cu`` ``sos_scan_is_wide``); any block is taken."""
    sos = np.tile(DESIGNS[design], (repeat, 1))
    tables = sos_scan.scan_tables(sos, block)
    nsh, ns = tables.nsh, len(sos)
    smem = 8 * (2 * block + 2 * ns) + 4 * ns * (sos_scan.HEAD + 4 * nsh)
    assert tables.wide is WIDE[design, repeat, block]
    assert tables.wide == (block > sos_scan.MAX_BLOCK
                           or smem > sos_scan.SMEM_MAX)


def test_a_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper or build was reached")

    before = sos_scan.sos_scan_cuda.launches
    monkeypatch.setattr(sos_scan, "sos_scan_cuda", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    x, zi = _inputs(EQ, 2, 5000, True)
    y, zf = iir.sosfilt(EQ, x, zi=zi, block_size=1024, return_zf=True)
    assert y.shape == x.shape and zf.shape == (2, len(EQ), 2)
    monkeypatch.undo()
    assert sos_scan.sos_scan_cuda.launches == before


#: what the wrapper refuses, and the words of its error
REFUSALS = {
    "float64": "float32",
    "one-dimensional": "float32",
    "not contiguous": "contiguous",
    "zi of another shape": "zi must be",
    "zi float64": "zi must be",
    "zi not contiguous": "zi must be",
    "a CPU tensor": "CUDA tensor",
}


def _refused_args(case):
    tables = sos_scan.scan_tables(EQ, 1024)
    x = torch.zeros((2, 3000), dtype=torch.float32)
    zi = torch.zeros((2, len(EQ), 2), dtype=torch.float32)
    return {"float64": (x.double(), tables, None),
            "one-dimensional": (x[0], tables, None),
            "not contiguous": (x.t().contiguous().t(), tables, None),
            "zi of another shape": (x, tables, zi[:, :4]),
            "zi float64": (x, tables, zi.double()),
            "zi not contiguous": (x, tables, zi.transpose(1, 2)
                                  .contiguous().transpose(1, 2)),
            "a CPU tensor": (x, tables, zi)}[case]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(case,
                                                            monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(_build, "load", refuse)
    before = sos_scan.sos_scan_cuda.launches
    with pytest.raises(ValueError, match=REFUSALS[case]):
        sos_scan.sos_scan_cuda(*_refused_args(case), return_zf=True)
    assert sos_scan.sos_scan_cuda.launches == before
