"""Per-layer approximation policies (port of ``repro.core.policy``).

An :class:`ApproxPolicy` describes how one linear layer executes on the
(emulated) approximate MAC array: multiplier family, its knob ``m``,
whether the control-variate correction is added, how many CV groups, and
which backend computes it.  ``backend: "pallas"`` is the JSON value both
packages read as "run the hand-written kernel": the TPU's Pallas kernel in
``repro``, the Hopper CUDA kernel here, so one spec-JSON file resolves the
same way in both.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

from repro_torch.core.multipliers import APPROX_MODES, PAPER_M_RANGE, Mode

Backend = Literal["jnp", "pallas"]


@dataclasses.dataclass(frozen=True)
class ApproxPolicy:
    """Static per-layer approximation configuration."""

    mode: Mode = "exact"  # multiplier family ("exact" = plain int8)
    m: int = 0  # approximation knob (paper Sec. 2)
    use_cv: bool = True  # add the control variate V (the paper's technique)
    groups: int = 1  # >1 = grouped CV (beyond paper; plain path only)
    backend: Backend = "jnp"

    def __post_init__(self):
        if self.mode != "exact" and not (0 <= self.m <= 8):
            raise ValueError(f"m={self.m} out of range for 8-bit codes")
        if self.groups < 1:
            raise ValueError("groups must be >= 1")

    @property
    def is_approx(self) -> bool:
        return self.mode != "exact" and self.m > 0

    def label(self) -> str:
        if not self.is_approx:
            return "int8-exact"
        cv = f"+cv(g={self.groups})" if self.use_cv else "-cv"
        return f"{self.mode}(m={self.m}){cv}"

    def to_dict(self) -> dict:
        return {"mode": self.mode, "m": self.m, "use_cv": self.use_cv,
                "groups": self.groups, "backend": self.backend}

    @classmethod
    def from_dict(cls, d: dict) -> "ApproxPolicy":
        unknown = set(d) - {"mode", "m", "use_cv", "groups", "backend"}
        if unknown:
            raise ValueError(f"unknown ApproxPolicy fields {sorted(unknown)}")
        return cls(**d)


FLOAT = None  # sentinel: layer stays in float (not packed)
INT8_EXACT = ApproxPolicy("exact", 0)


def paper_policies(use_cv: bool = True,
                   backend: Backend = "jnp") -> list[ApproxPolicy]:
    """The grid the paper evaluates (Tables 2-4)."""
    return [ApproxPolicy(mode, m, use_cv=use_cv, backend=backend)
            for mode in APPROX_MODES for m in PAPER_M_RANGE[mode]]


#: path (tuple of str keys) -> policy, or None to keep the layer float
PolicyFn = Callable[[tuple[str, ...]], ApproxPolicy | None]
