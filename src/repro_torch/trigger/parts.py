"""Named FPGA parts: the resource envelopes budgets are checked against.

The collider-trigger synthesis study (PAPERS.md: 2411.11678) and hls4ml
(1804.06913) both frame deployment as "does the design fit the latency
AND resource envelope of a *named part*".  This catalog makes the part a
first-class value instead of a scattered constant: ``alveo_u280`` is the
paper's deployment device (9,024 DSP slices), ``zcu102`` is the
embedded-class comparison point, and :func:`part` builds a synthetic
device for tests and what-if studies.

A :class:`Part` speaks the same resource vocabulary as
``Schedule.resources()`` — DSP units, FF (registered live values),
BRAM ports, LUT units — via :meth:`Part.caps`, so a budget check is a
straight per-resource comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class Part:
    """One named device: its usable resource pools.

    ``bram`` counts 36 Kb block instances; the schedule's resource model
    accounts *ports* (dual-ported blocks), so the comparable cap is
    ``2 * bram`` — :meth:`caps` does that mapping.  A ``None`` pool means
    "unconstrained" (e.g. a synthetic test part capping only DSPs).
    """

    name: str
    dsp: Optional[int] = None
    ff: Optional[int] = None
    bram: Optional[int] = None
    lut: Optional[int] = None

    def caps(self) -> dict[str, int]:
        """Per-resource caps keyed like ``Schedule.resources()``.

        Only constrained pools appear; BRAM blocks are exposed as ports
        (2 per dual-ported block).
        """
        out: dict[str, int] = {}
        if self.dsp is not None:
            out["DSP"] = self.dsp
        if self.ff is not None:
            out["FF"] = self.ff
        if self.bram is not None:
            out["BRAM_ports"] = 2 * self.bram
        if self.lut is not None:
            out["LUT_units"] = self.lut
        return out

    def summary(self) -> str:
        pools = ", ".join(f"{k}={v:,}" for k, v in self.caps().items())
        return f"{self.name}: {pools or '(unconstrained)'}"


#: Xilinx Alveo U280 (the paper's deployment device, §4.2): 9,024 DSP
#: slices, 2.6 M flip-flops, 2,016 36Kb BRAM blocks, 1.3 M LUTs.
alveo_u280 = Part("alveo_u280", dsp=9024, ff=2_607_360, bram=2016,
                  lut=1_303_680)

#: Zynq UltraScale+ ZCU102 (XCZU9EG) — the embedded trigger-board class:
#: 2,520 DSPs, 548 K FFs, 912 36Kb BRAMs, 274 K LUTs.
zcu102 = Part("zcu102", dsp=2520, ff=548_160, bram=912, lut=274_080)

#: The catalog, by name.  ``part()`` makes synthetic entries; register
#: real devices here so budgets can name them.
PARTS: dict[str, Part] = {p.name: p for p in (alveo_u280, zcu102)}


def part(*, dsp: Optional[int] = None, ff: Optional[int] = None,
         bram: Optional[int] = None, lut: Optional[int] = None,
         name: str = "custom") -> Part:
    """A synthetic part with explicit pools (``None`` = unconstrained).

    The what-if device for tests and capacity studies::

        tiny = part(dsp=16)           # deliberately infeasible
        design.check_budget(part=tiny)
    """
    return Part(name, dsp=dsp, ff=ff, bram=bram, lut=lut)


def get_part(p: Union[str, Part, None]) -> Optional[Part]:
    """Resolve a part reference: a ``Part``, a catalog name, or ``None``."""
    if p is None or isinstance(p, Part):
        return p
    if p in PARTS:
        return PARTS[p]
    raise KeyError(f"unknown part {p!r}; catalog: {sorted(PARTS)} "
                   f"(or build one with trigger.part(dsp=..., ...))")
