"""The least time of a cascade of second-order sections on a card, at the
published peaks (``peaks.json``).  The counts are those of the cheapest
correct implementation, not of the program's scan, so that no later
implementation (a scan kernel) can read above 100 %:

* bytes: each input sample read once and each output sample written once,
  float32: 8 B a sample;
* operations: a section in transposed direct form II, 5 products and 4
  sums, 9 FLOP a sample, at the fp32 rate (the recurrence is elementwise;
  no tensor core runs it)."""

from __future__ import annotations

BYTES_PER_SAMPLE = 8.0
FLOP_PER_SECTION_SAMPLE = 9.0


def cascade_least_s(sections: int, pk: dict, samples: float):
    """``(seconds, "compute" | "bytes")``: the least time of the cascade
    of ``sections`` over ``samples`` samples (every channel), and which
    bound sets it."""
    compute = FLOP_PER_SECTION_SAMPLE * sections * samples / (
        pk["fp32_tflops"] * 1e12)
    moved = BYTES_PER_SAMPLE * samples / (pk["hbm_tbps"] * 1e12)
    return (compute, "compute") if compute >= moved else (moved, "bytes")
