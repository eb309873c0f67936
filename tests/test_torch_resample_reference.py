"""The port's polyphase resampler on its normal path,
``Chain([ResampleStage(147, 160)])`` streamed in blocks and
``resample_poly`` in one call, against the plain float64 ``upfirdn``
reference (``tests/resample_reference.py``, which imports nothing of the
port), on seeded taps and seeded signals; the reference from its
definition, against SciPy's ``upfirdn`` and against its copy in the
benchmark."""

import ast
import inspect
import os

import numpy as np
import pytest
import scipy.signal as ss
import torch

from llzlab_tpu_torch.ops.resample import resample_poly
from llzlab_tpu_torch.pipeline.chain import Chain, ResampleStage
from tests import resample_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UP, DOWN, K = 147, 160, 64
#: the relative L2 error the port keeps under: its float32 product of 223
#: columns (64 taps a phase) against float64 reads 7e-8 to 1e-7 on these
#: signals; TF32 operands read 2e-4 to 4e-4, over 100 times this
REL_L2 = 1e-6


def _taps(seed):
    """Seeded random prototype taps, ``up · K`` of them, float64."""
    return np.random.default_rng(seed).standard_normal(UP * K)


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _rel_l2(got, want):
    return float((got.to(torch.float64) - want).norm() / want.norm())


def _streamed(taps, x, block, zi=None):
    chain = Chain([ResampleStage(UP, DOWN, taps=taps)])
    state = chain.init_state(x.shape[:-1], device="cpu")
    if zi is not None:
        state = (zi,)
    out = []
    for piece in x.split(block, dim=-1):
        y, state = chain.apply(piece, state)
        out.append(y)
    return torch.cat(out, dim=-1), state


@pytest.mark.parametrize("block,seed", [(160, 51), (800, 52), (1600, 53)])
def test_the_streamed_chain_against_the_plain_reference(block, seed):
    taps = _taps(seed)
    x = _x((8, 3200), seed + 100)
    got, state = _streamed(taps, x, block)
    want = resample_reference.resample(x, taps, UP, DOWN)
    assert got.shape == want.shape == (8, 2940)
    assert _rel_l2(got, want) <= REL_L2
    # the state carried is the last K - 1 input samples
    assert torch.equal(state[0], x[:, -(K - 1):])
    # the control, TF32 operands, fails the same tolerance by far
    control = resample_reference.resample(x, taps, UP, DOWN,
                                          rounding="tf32")
    assert _rel_l2(control, want) > 100 * REL_L2


@pytest.mark.parametrize("t", [1000, 3333, 161])
def test_one_call_of_a_length_that_is_no_multiple_of_down(t):
    taps = _taps(54)
    x = _x((8, t), 154)
    got = resample_poly(x, UP, DOWN, taps=taps)
    want = resample_reference.resample(x, taps, UP, DOWN)
    assert got.shape == want.shape == (8, -(-t * UP // DOWN))
    assert _rel_l2(got, want) <= REL_L2


def test_a_stream_from_a_history_that_is_not_zero():
    taps = _taps(55)
    x = _x((8, 3200), 155)
    zi = _x((8, K - 1), 156)
    want = resample_reference.resample(x, taps, UP, DOWN, zi=zi)
    got, _ = _streamed(taps, x, 800, zi=zi)
    assert _rel_l2(got, want) <= REL_L2
    one = resample_poly(x, UP, DOWN, taps=taps, zi=zi)
    assert _rel_l2(one, want) <= REL_L2
    # the history weighs: without it the first outputs differ
    cold = resample_reference.resample(x, taps, UP, DOWN)
    assert _rel_l2(cold, want) > 1e-3


def test_the_benchmarks_design_through_the_stage():
    """The 147/160 kaiser-8 prototype the stage designs, a smooth band of
    noise: the error stays at float32's rounding."""
    stage = ResampleStage(UP, DOWN)
    x = _x((8, 4000), 157)
    y, _ = Chain([stage]).apply(x, Chain([stage]).init_state(
        (8,), device="cpu"))
    want = resample_reference.resample(x, stage.taps, UP, DOWN)
    assert _rel_l2(y, want) <= REL_L2


def test_the_reference_against_scipys_upfirdn():
    rng = np.random.default_rng(58)
    h = rng.standard_normal(UP * 8 + 5)  # no multiple of up
    x = rng.standard_normal((3, 700))
    n = resample_reference.output_len(700, UP, DOWN)
    want = np.stack([ss.upfirdn(h, row, UP, DOWN)[:n] for row in x])
    got = resample_reference.resample(torch.from_numpy(x), h, UP, DOWN)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("up,down,ntaps", [(3, 4, 7), (4, 3, 12),
                                           (2, 5, 9)])
def test_the_reference_is_the_definitions_whole_sum(up, down, ntaps):
    """Every term of ``Σ_j h[j] x_up[m·down − j]``, zeros included, over a
    literally zero-stuffed input behind its history."""
    rng = np.random.default_rng(up * 100 + down)
    h = rng.standard_normal(ntaps)
    x = rng.standard_normal((2, 17))
    zi = rng.standard_normal((2, 4))
    ctx = np.concatenate([zi, x], axis=1)
    x_up = np.zeros((2, ctx.shape[1] * up))
    x_up[:, ::up] = ctx
    origin = zi.shape[1] * up
    n = -(-17 * up // down)
    want = np.zeros((2, n))
    for m in range(n):
        for j in range(ntaps):
            p = origin + m * down - j
            if 0 <= p < x_up.shape[1]:
                want[:, m] += h[j] * x_up[:, p]
    got = resample_reference.resample(torch.from_numpy(x), h, up, down,
                                      zi=torch.from_numpy(zi))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_the_rounding_from_its_definition():
    # 1 + 2^-11 is halfway between two TF32 values: to even, down to 1;
    # 1 + 3·2^-11 rounds up to 1 + 2^-9
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0],
                     dtype=torch.float64)
    assert resample_reference.round_tf32(t).tolist() == [
        1.0, 1.0 + 2.0 ** -9, -3.0]
    with pytest.raises(ValueError, match="rounding"):
        resample_reference.resample(t[None], [1.0], 1, 1, rounding="bf16")


def test_the_benchmarks_copy_is_the_same_file_and_imports_nothing():
    with open(os.path.join(ROOT, "tests", "resample_reference.py")) as f:
        mine = f.read()
    with open(os.path.join(ROOT, "portbench", "reference_resample.py")) as f:
        theirs = f.read()
    assert mine == theirs
    names = {n.name for n in ast.parse(mine).body
             if isinstance(n, ast.FunctionDef)}
    assert names == {"round_tf32", "output_len", "resample"}
    imported = set()
    for node in ast.walk(ast.parse(mine)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert imported <= {"__future__", "torch"}
    assert "highest" in inspect.getdoc(resample_reference)
