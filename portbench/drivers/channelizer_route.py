"""Drives ``Channelizer.step`` (``chains/channelizer.py``) as
``channelizer_step.py`` does (its ``Driver``, which this one extends:
the closed loop of at most two steps in flight, the input super-blocks
made on the card from the seed and taken in turn, the kept frames and the
channelizer check), on the route the workload names (``fir_method``) in
place of the configuration's ``auto``.  With ``"block2"`` a step is kernel
B2's FIR, ``ops/resample.py``'s dense polyphase product and cuFFT's
frames."""

from __future__ import annotations

from portbench.drivers import channelizer_step

CHECK = channelizer_step.CHECK


class Driver(channelizer_step.Driver):
    def __init__(self, cfg, wl, seed, devices, spans, sizes=None):
        super().__init__(cfg, wl, seed, devices, spans,
                         dict(sizes or {}, fir_method=wl["fir_method"]))
