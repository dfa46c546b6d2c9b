"""Declarative, serializable numerics configuration (port of
``repro.numerics``): spec -> plan -> packed parameters."""

from repro_torch.numerics.plan import PackPlan, PlanEntry, apply_numerics
from repro_torch.numerics.presets import (PRESETS, SERVE_FLOAT_RULES,
                                          get_preset, paper_grid_specs,
                                          uniform_spec)
from repro_torch.numerics.spec import FLOAT, NumericsSpec, Rule, match_path

__all__ = ["NumericsSpec", "Rule", "FLOAT", "match_path", "PackPlan",
           "PlanEntry", "apply_numerics", "PRESETS", "SERVE_FLOAT_RULES",
           "get_preset", "paper_grid_specs", "uniform_spec"]
