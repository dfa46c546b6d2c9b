"""Declarative numerics specification (port of ``repro.numerics.spec``).

A :class:`NumericsSpec` holds ordered :class:`Rule`s — pattern on the
parameter-tree path, first match wins — plus a default action, and
round-trips through the same JSON as the reference, so one spec file
configures both packages.  Actions: an :class:`ApproxPolicy`, or ``FLOAT``
(None) to keep the layer float.  ``auto(...)`` rules (a greedy search that
needs model forwards) are not ported yet and are refused.

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
from typing import Any

from repro_torch.core.policy import INT8_EXACT, ApproxPolicy

FLOAT = None

Action = ApproxPolicy | None


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
    if isinstance(action, ApproxPolicy):
        return {"policy": action.to_dict()}
    raise TypeError(f"not a rule action: {action!r}")


def _action_from_dict(obj: Any) -> Action:
    if obj == "float" or obj is None:
        return None
    if isinstance(obj, dict) and "auto" in obj:
        raise NotImplementedError("auto(...) rules are not ported yet")
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

    def resolve(self, params: Any):
        """Resolve against a float parameter tree into a PackPlan (shapes
        only)."""
        from repro_torch.core.approx_linear import is_linear_params
        from repro_torch.numerics.plan import PackPlan, plan_entry

        entries = []

        def walk(node: Any, path: tuple[str, ...]):
            if is_linear_params(node):
                action, source = self.action_for(path)
                entries.append(plan_entry("/".join(path), node, action, source))
            elif isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))

        walk(params, ())
        return PackPlan(spec_name=self.name, entries=tuple(entries))
