"""What the checks of every entry share: the numbers compared, each with
its limit, and the QPSK hard decision's distance from its boundaries."""

from __future__ import annotations

import numpy as np

_SQRT2 = np.sqrt(2.0)


def rail_margin(phasors: np.ndarray) -> np.ndarray:
    """[..., B] phasors -> [..., 2B]: how far each rail's component lies
    from where its hard bit flips (0 and +-sqrt(2): the reference's
    ``bit_recovery`` compares ||c| - sqrt(2)/2| with sqrt(2)/2), in the
    bits' order (real rail first)."""
    c = np.stack([phasors.real, phasors.imag], -1)
    a = np.abs(c)
    return np.minimum(a, np.abs(a - _SQRT2)).reshape(*phasors.shape[:-1], -1)


def wrong_bits(got: np.ndarray, want: np.ndarray, ref_phasors: np.ndarray,
               band: float) -> int:
    """Hard bits that differ from the reference's where the reference's
    component lies farther than ``band`` from a boundary: within it a
    rounding of the phasor may flip the bit, beyond it only a fault can."""
    margin = rail_margin(ref_phasors).reshape(got.shape)
    return int(((got != want) & (margin > band)).sum())


class Tally:
    """The numbers a run's check compares: ``worst`` keeps the largest
    reading of each, ``limits`` its limit."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.worst = {name: 0.0 for name in self.limits}
        self.failed = 0
        self.checked = 0
        self.followed = 0

    def add(self, readings: dict) -> None:
        self.checked += 1
        bad = False
        for name, value in readings.items():
            self.worst[name] = max(self.worst[name], float(value))
            bad |= float(value) > self.limits[name]
        self.failed += bad

    @property
    def correct(self) -> bool:
        return self.checked > 0 and all(
            self.worst[n] <= self.limits[n] for n in self.limits)

    def lines(self) -> dict:
        return {n: {"value": self.worst[n], "limit": self.limits[n]}
                for n in self.limits}
