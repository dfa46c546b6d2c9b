"""Degradation ladder (port of ``repro.numerics.ladder``): the ordered
NumericsSpec rungs the SLO governor walks
(:mod:`repro_torch.serving.governor`).

A ladder is most-approximate-first: rung 0 is the cheapest (highest
modeled MAC-array power saving), the last rung the most exact (float, the
always-safe floor).  Escalating moves right (spends power to buy
accuracy), relaxing moves left (re-harvests power).  ``resolve_ladder``
turns preset names / spec-JSON paths into rungs carrying the mean modeled
power saving of their resolved :class:`~repro_torch.numerics.plan.
PackPlan`, so every governor switch records the power it traded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.numerics.presets import get_preset
from repro_torch.numerics.spec import NumericsSpec

__all__ = ["DEFAULT_LADDER", "LadderRung", "ladder_spec", "resolve_ladder"]

#: the production default: perforated-m2+CV serving, exact int8 under
#: pressure, float as the floor
DEFAULT_LADDER: tuple[str, ...] = ("serve-default", "int8", "float")


@dataclasses.dataclass(frozen=True)
class LadderRung:
    """One governor rung: a spec (None = raw float params) plus the mean
    modeled power saving of its packed layers (cost-model %, 0 for
    exact/float rungs)."""

    name: str
    spec: NumericsSpec | None
    power_saving_pct: float


def ladder_spec(name: str) -> tuple[str, NumericsSpec | None]:
    """Resolve one ladder entry name: ``"float"``, a preset name, or a
    path to a NumericsSpec JSON file."""
    if name == "float":
        return "float", None
    if name.endswith(".json"):
        with open(name) as f:
            spec = NumericsSpec.from_json(f.read())
        return spec.name, spec
    spec = get_preset(name)
    return spec.name, spec


def resolve_ladder(names: Sequence[str | NumericsSpec | None],
                   params: Any) -> list[LadderRung]:
    """Build governor rungs from ladder entries, resolving each spec
    against ``params`` (real or ``meta`` tensors) for its modeled power
    saving.  Entries are names (:func:`ladder_spec`) or NumericsSpec
    objects (None = float).  Power savings must not increase toward the
    exact end, else "escalate" would REDUCE accuracy spend."""
    if len(names) < 2:
        raise ValueError(f"a governor ladder needs >= 2 rungs, got "
                         f"{list(names)!r}")
    rungs: list[LadderRung] = []
    for entry in names:
        if entry is None or isinstance(entry, NumericsSpec):
            label, spec = (entry.name, entry) if entry is not None \
                else ("float", None)
        else:
            label, spec = ladder_spec(entry)
        if spec is None:
            saving = 0.0
        else:
            packed = spec.resolve(params).packed
            saving = (sum(e.power_saving_pct for e in packed) / len(packed)
                      if packed else 0.0)
        rungs.append(LadderRung(label, spec, round(saving, 2)))
    for lo, hi in zip(rungs, rungs[1:]):
        if lo.power_saving_pct < hi.power_saving_pct:
            raise ValueError(
                "ladder must be ordered most-approximate first: "
                f"{lo.name} saves {lo.power_saving_pct}% < "
                f"{hi.name} saves {hi.power_saving_pct}%")
    return rungs
