"""Declarative numerics specification (port of ``repro.numerics.spec``).

A :class:`NumericsSpec` holds ordered :class:`Rule`s — pattern on the
parameter-tree path, first match wins — plus a default action, and
round-trips through the same JSON as the reference, so one spec file
configures both packages.  Actions: an :class:`ApproxPolicy`; ``FLOAT``
(None) to keep the layer float; or :func:`auto`, which defers to the
greedy ALWANN-style per-layer search at resolve time, bounded by an error
budget (``resolve`` then needs ``apply_fn=`` and ``calib_inputs=``).

Patterns are segment-anchored: a glob without ``/`` must fnmatch one whole
path segment; a pattern with ``/`` matches the full joined path (``*``
within a segment, ``**`` across segments); ``regex`` rules ``re.search``
the joined path.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import re
from typing import Any, Union

from repro_torch.core.policy import INT8_EXACT, ApproxPolicy, paper_policies

FLOAT = None


@dataclasses.dataclass(frozen=True)
class Auto:
    """Deferred per-layer assignment: lowered to concrete policies by the
    greedy search during :meth:`NumericsSpec.resolve`.  ``candidates``
    names a registered candidate set, so the rule stays serializable."""

    budget_rel_err: float = 0.05
    candidates: str = "paper-grid"

    def __post_init__(self):
        if self.budget_rel_err <= 0:
            raise ValueError("budget_rel_err must be positive")
        if self.candidates not in CANDIDATE_SETS:
            raise ValueError(
                f"unknown candidate set {self.candidates!r}; "
                f"known: {sorted(CANDIDATE_SETS)}")


def auto(budget: float = 0.05, candidates: str = "paper-grid") -> Auto:
    """Rule action: pick the most aggressive policy per layer whose model
    output error stays under ``budget`` (relative, on calibration inputs)."""
    return Auto(budget_rel_err=budget, candidates=candidates)


#: Named candidate sets an ``auto`` rule may search over (zero-argument
#: functions that list them, serializable by name).
CANDIDATE_SETS = {
    "paper-grid": lambda: paper_policies(use_cv=True),
    "paper-grid-nocv": lambda: paper_policies(use_cv=False),
}

Action = Union[ApproxPolicy, Auto, None]


def _match_segments(pat: list[str], segs: tuple[str, ...]) -> bool:
    if not pat:
        return not segs
    head, rest = pat[0], pat[1:]
    if head == "**":
        return any(_match_segments(rest, segs[i:]) for i in range(len(segs) + 1))
    if not segs:
        return False
    return fnmatch.fnmatchcase(segs[0], head) and _match_segments(rest, segs[1:])


def match_path(pattern: str, path: tuple[str, ...], kind: str = "glob") -> bool:
    """Segment-anchored rule matching (see module docstring)."""
    if kind == "regex":
        return re.search(pattern, "/".join(path)) is not None
    if kind != "glob":
        raise ValueError(f"unknown rule kind {kind!r} (glob|regex)")
    if "/" in pattern:
        return _match_segments(pattern.split("/"), tuple(path))
    return any(fnmatch.fnmatchcase(seg, pattern) for seg in path)


def _action_to_dict(action: Action) -> Any:
    if action is None:
        return "float"
    if isinstance(action, Auto):
        return {"auto": {"budget_rel_err": action.budget_rel_err,
                         "candidates": action.candidates}}
    if isinstance(action, ApproxPolicy):
        return {"policy": action.to_dict()}
    raise TypeError(f"not a rule action: {action!r}")


def _action_from_dict(obj: Any) -> Action:
    if obj == "float" or obj is None:
        return None
    if isinstance(obj, dict) and "auto" in obj:
        return Auto(**obj["auto"])
    if isinstance(obj, dict) and "policy" in obj:
        return ApproxPolicy.from_dict(obj["policy"])
    raise ValueError(f"unrecognized action {obj!r}")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One ordered pattern -> action entry; ``note`` says why it exists."""

    pattern: str
    action: Action = FLOAT
    kind: str = "glob"  # "glob" | "regex"
    note: str = ""

    def __post_init__(self):
        if self.kind not in ("glob", "regex"):
            raise ValueError(f"rule kind must be glob|regex, got {self.kind!r}")
        if self.kind == "regex":
            re.compile(self.pattern)

    def matches(self, path: tuple[str, ...]) -> bool:
        return match_path(self.pattern, path, self.kind)

    def to_dict(self) -> dict:
        d = {"pattern": self.pattern, "action": _action_to_dict(self.action)}
        if self.kind != "glob":
            d["kind"] = self.kind
        if self.note:
            d["note"] = self.note
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(pattern=d["pattern"],
                   action=_action_from_dict(d.get("action", "float")),
                   kind=d.get("kind", "glob"), note=d.get("note", ""))


@dataclasses.dataclass(frozen=True)
class NumericsSpec:
    """Ordered, serializable per-layer numerics configuration."""

    name: str
    rules: tuple[Rule, ...] = ()
    default: Action = INT8_EXACT

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def action_for(self, path: tuple[str, ...]) -> tuple[Action, str]:
        """(action, source) for one layer path."""
        for rule in self.rules:
            if rule.matches(path):
                return rule.action, rule.pattern
        return self.default, "default"

    @property
    def is_exact(self) -> bool:
        """True when no layer this spec can assign runs on the approximate
        MAC array: every rule action and the default are FLOAT or exact
        int8 (decidable from the spec alone).  ``auto`` rules count as
        non-exact: they may lower to an approximate policy."""
        def _exact(action: Action) -> bool:
            return action is None or (isinstance(action, ApproxPolicy)
                                      and not action.is_approx)

        return (_exact(self.default)
                and all(_exact(r.action) for r in self.rules))

    def to_dict(self) -> dict:
        return {"version": 1, "name": self.name,
                "rules": [r.to_dict() for r in self.rules],
                "default": _action_to_dict(self.default)}

    @classmethod
    def from_dict(cls, d: dict) -> "NumericsSpec":
        if d.get("version", 1) != 1:
            raise ValueError(f"unsupported NumericsSpec version {d['version']}")
        return cls(name=d["name"],
                   rules=tuple(Rule.from_dict(r) for r in d.get("rules", ())),
                   default=_action_from_dict(d.get("default", "float")))

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "NumericsSpec":
        return cls.from_dict(json.loads(s))

    def resolve(self, params: Any, *, apply_fn=None, calib_inputs=None,
                act_ranges: dict | None = None, n_array: int = 64):
        """Resolve against a float parameter tree into a PackPlan.  Only
        shapes are read (``meta`` tensors do), unless an ``auto`` rule
        fires: that runs the greedy search on real values through
        ``apply_fn(params, calib_inputs)`` (optionally with the
        calibrated ``act_ranges``)."""
        from repro_torch.core.approx_linear import is_linear_params
        from repro_torch.numerics.plan import PackPlan, plan_entry

        assignments: list[tuple[str, Any, Action, str]] = []

        def walk(node: Any, path: tuple[str, ...]):
            if is_linear_params(node):
                action, source = self.action_for(path)
                assignments.append(("/".join(path), node, action, source))
            elif isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))

        walk(params, ())
        auto_items = [(joined, action) for joined, _, action, _
                      in assignments if isinstance(action, Auto)]
        lowered: dict[str, ApproxPolicy] = {}
        if auto_items:
            lowered = _lower_auto(params, auto_items, apply_fn, calib_inputs,
                                  act_ranges)
        entries = []
        for joined, node, action, source in assignments:
            if isinstance(action, Auto):
                policy = lowered[joined]
                source = f"{source} [auto<= {action.budget_rel_err}]"
            else:
                policy = action
            entries.append(plan_entry(joined, node, policy, source,
                                      n_array=n_array))
        return PackPlan(spec_name=self.name, entries=tuple(entries))


def _lower_auto(params: Any, auto_items: list[tuple[str, Auto]], apply_fn,
                calib_inputs, act_ranges: dict | None) -> dict[str, ApproxPolicy]:
    """Lower ``auto`` rules through the greedy ALWANN-style core
    (:func:`repro_torch.core.policy.greedy_assign`)."""
    if apply_fn is None or calib_inputs is None:
        raise ValueError(
            "spec contains auto(...) rules; resolve() needs apply_fn= and "
            "calib_inputs= to run the greedy search (auto rules cannot be "
            "resolved on abstract shape-only trees)")

    from repro_torch.core.policy import greedy_assign, order_most_aggressive

    ordered = {name: order_most_aggressive(CANDIDATE_SETS[name]())
               for name in {a.candidates for _, a in auto_items}}
    items = [(joined, ordered[a.candidates], a.budget_rel_err)
             for joined, a in auto_items]
    return greedy_assign(apply_fn, params, calib_inputs, items,
                         act_ranges=act_ranges)
