"""Named NumericsSpec presets (port of ``repro.numerics.presets``).

  * ``serve-default`` — the serving keep-float rule-set plus one uniform
    policy (perforated m=2 + CV by default) everywhere else;
  * ``int8`` — the same rule-set, exact int8 everywhere else;
  * ``paper-grid`` — the same rule-set, ``auto(budget)`` everywhere else:
    the greedy per-layer search over the paper's grid (resolving it needs
    calibration inputs).

``paper_grid_specs()`` expands the paper's Tables 2-4 grid into one uniform
spec per (multiplier, m) point, the form a sweep iterates.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.policy import (INT8_EXACT, ApproxPolicy, Backend,
                                     paper_policies)
from repro_torch.numerics.spec import FLOAT, Auto, NumericsSpec, Rule

#: The serving keep-float rule-set (segment-anchored globs).
SERVE_FLOAT_RULES: tuple[Rule, ...] = (
    Rule("embed*", FLOAT, note="token embedding: a lookup, not a GEMM"),
    Rule("router", FLOAT, note="MoE router: control logic stays exact"),
    Rule("kv_a", FLOAT, note="MLA latent down-proj: absorbed-decode einsum"),
    Rule("kv_b", FLOAT, note="MLA latent up-proj: absorbed-decode einsum"),
    Rule("*norm", FLOAT, note="norm scales: elementwise, no MAC array"),
    Rule("dt_proj", FLOAT, note="SSM dt projection: tiny, timestep-critical"),
    Rule("x_proj", FLOAT, note="SSM input mix: tiny low-rank projection"),
)


def serve_default(policy: ApproxPolicy | None = None) -> NumericsSpec:
    pol = policy if policy is not None else ApproxPolicy("perforated", 2,
                                                         use_cv=True)
    return NumericsSpec(name=f"serve-default[{pol.label()}]",
                        rules=SERVE_FLOAT_RULES, default=pol)


def int8() -> NumericsSpec:
    return NumericsSpec(name="int8", rules=SERVE_FLOAT_RULES,
                        default=INT8_EXACT)


def paper_grid(budget: float = 0.05) -> NumericsSpec:
    return NumericsSpec(name=f"paper-grid[auto<={budget}]",
                        rules=SERVE_FLOAT_RULES,
                        default=Auto(budget_rel_err=budget))


PRESETS = {"serve-default": serve_default, "int8": int8,
           "paper-grid": paper_grid}


def get_preset(name: str, **kwargs) -> NumericsSpec:
    """Build a named preset spec (``policy=`` for serve-default,
    ``budget=`` for paper-grid)."""
    try:
        builder = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown numerics preset {name!r}; "
                         f"known: {sorted(PRESETS)}") from None
    return builder(**kwargs)


def uniform_spec(policy: ApproxPolicy | None, rules: tuple[Rule, ...] = (),
                 name: str | None = None) -> NumericsSpec:
    """One policy everywhere (after ``rules``)."""
    label = "float" if policy is None else policy.label()
    return NumericsSpec(name=name or f"uniform[{label}]", rules=rules,
                        default=policy)


def paper_grid_specs(use_cv: bool = True, backend: Backend = "jnp",
                     rules: tuple[Rule, ...] = ()) -> list[NumericsSpec]:
    """The Tables 2-4 sweep: one uniform spec per (multiplier, m) grid
    point, in the paper's presentation order."""
    return [dataclasses.replace(uniform_spec(p, rules=rules),
                                name=f"paper-grid/{p.label()}")
            for p in paper_policies(use_cv=use_cv, backend=backend)]
