"""Declarative, serializable numerics configuration (port of
``repro.numerics``): spec -> plan -> packed parameters."""

from repro_torch.numerics.ladder import (DEFAULT_LADDER, LadderRung,
                                         ladder_spec, resolve_ladder)
from repro_torch.numerics.plan import PackPlan, PlanEntry, apply_numerics
from repro_torch.numerics.presets import (PRESETS, SERVE_FLOAT_RULES,
                                          get_preset, paper_grid_specs,
                                          uniform_spec)
from repro_torch.numerics.spec import (FLOAT, Auto, NumericsSpec, Rule, auto,
                                       match_path)

__all__ = ["NumericsSpec", "Rule", "Auto", "auto", "FLOAT", "match_path",
           "PackPlan", "PlanEntry", "apply_numerics", "DEFAULT_LADDER",
           "LadderRung", "ladder_spec", "resolve_ladder", "PRESETS",
           "SERVE_FLOAT_RULES", "get_preset", "paper_grid_specs",
           "uniform_spec"]
