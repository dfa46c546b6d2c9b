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


def uniform_policy(policy: ApproxPolicy | None,
                   skip: tuple[str, ...] = ()) -> PolicyFn:
    """One policy for every linear layer, except paths containing any of
    the ``skip`` substrings."""

    def fn(path: tuple[str, ...]) -> ApproxPolicy | None:
        joined = "/".join(path)
        if any(s in joined for s in skip):
            return None
        return policy

    return fn


# ---------------------------------------------------------------------------
# Automatic per-layer policy search (beyond paper; ALWANN-flavoured)
# ---------------------------------------------------------------------------


def order_most_aggressive(candidates: list[ApproxPolicy]) -> list[ApproxPolicy]:
    """Candidates sorted most-aggressive-first by the analytic error sigma
    (a stable sort: ties keep their given order)."""
    from repro_torch.core.multipliers import analytic_error_moments_uniform

    return sorted(
        candidates,
        key=lambda p: analytic_error_moments_uniform(p.mode, p.m)[1],
        reverse=True)


def greedy_assign(apply_fn, params, calib_inputs,
                  items: list[tuple[str, list[ApproxPolicy], float]],
                  act_ranges: dict | None = None) -> dict[str, ApproxPolicy]:
    """The greedy ALWANN-style per-layer assignment core (shared by
    :func:`auto_policy` and the ``auto(...)`` rule lowering in
    :mod:`repro_torch.numerics`).

    ``items`` is ``[(path, candidates, budget_rel_err)]``, candidates
    ordered most-aggressive-first (:func:`order_most_aggressive`).  Per
    layer, independently, the first candidate whose model-output relative
    error on the calibration inputs fits the budget wins; a layer too
    sensitive for every candidate falls back to exact int8."""
    from repro_torch.core.approx_linear import pack_params

    ref = apply_fn(params, calib_inputs)
    ref_scale = float(ref.abs().mean()) + 1e-12
    out: dict[str, ApproxPolicy] = {}
    for path, candidates, budget in items:
        chosen = INT8_EXACT
        for cand in candidates:
            one = pack_params(
                params,
                lambda p, path=path, cand=cand:
                    cand if "/".join(p) == path else None,
                act_ranges=act_ranges)
            err = float((apply_fn(one, calib_inputs) - ref).abs().mean())
            if err / ref_scale <= budget:
                chosen = cand
                break
        out[path] = chosen
    return out


def auto_policy(apply_fn, params, calib_inputs, *,
                candidates: list[ApproxPolicy] | None = None,
                budget_rel_err: float = 0.05, skip: tuple[str, ...] = (),
                act_ranges: dict | None = None):
    """Greedy per-layer approximation assignment over every packable
    linear layer (paths containing a ``skip`` substring stay float).
    Returns (policy_fn, rows ``[{"layer", "policy"}]``)."""
    from repro_torch.core.approx_linear import pack_params, packed_layer_paths

    candidates = order_most_aggressive(candidates
                                       or paper_policies(use_cv=True))
    probe = pack_params(params, uniform_policy(INT8_EXACT, skip=skip),
                        act_ranges=act_ranges)
    paths = packed_layer_paths(probe)
    policy_map = greedy_assign(
        apply_fn, params, calib_inputs,
        [(path, candidates, budget_rel_err) for path in paths],
        act_ranges=act_ranges)
    rows = [{"layer": path, "policy": policy_map[path].label()}
            for path in paths]

    def fn(p: tuple[str, ...]):
        return policy_map.get("/".join(p))

    return fn, rows
