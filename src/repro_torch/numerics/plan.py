"""PackPlan: the concrete result of resolving a NumericsSpec (port of
``repro.numerics.plan``).

A plan is the per-layer assignment table — path, policy (or float), the
rule that decided it, weight shape, packed serving bytes and the modelled
power saving of the assigned MAC array (``core.cost_model``).
``apply_numerics`` executes it through
:func:`~repro_torch.core.approx_linear.pack_params`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

from repro_torch.core.policy import ApproxPolicy


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One layer's resolved assignment."""

    path: str
    policy: ApproxPolicy | None  # None = layer stays float
    rule: str
    w_shape: tuple[int, ...]
    has_bias: bool
    packed_bytes: int
    power_saving_pct: float

    @property
    def label(self) -> str:
        return "float" if self.policy is None else self.policy.label()

    def to_dict(self) -> dict:
        return {"path": self.path,
                "policy": None if self.policy is None else self.policy.to_dict(),
                "rule": self.rule, "w_shape": list(self.w_shape),
                "has_bias": self.has_bias, "packed_bytes": self.packed_bytes,
                "power_saving_pct": self.power_saving_pct}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanEntry":
        pol = d.get("policy")
        return cls(path=d["path"],
                   policy=None if pol is None else ApproxPolicy.from_dict(pol),
                   rule=d["rule"], w_shape=tuple(int(x) for x in d["w_shape"]),
                   has_bias=bool(d["has_bias"]),
                   packed_bytes=int(d["packed_bytes"]),
                   power_saving_pct=float(d["power_saving_pct"]))


def _packed_bytes(w_shape: tuple[int, ...], policy: ApproxPolicy | None,
                  has_bias: bool) -> int:
    """Serving bytes of one layer: float layers at f32; packed layers as
    uint8 codes + int32 column sums + f32 CV constants (``groups`` rows of
    C) (+ bias), plus what the serving path reads on top: the blocked
    kernel layout of pallas-backend single-CV approximate layers, else the
    folded operands (:func:`_fold_bytes`)."""
    n_elem = math.prod(w_shape)
    if policy is None:
        return 4 * n_elem + (4 * w_shape[-1] if has_bias else 0)
    *lead, k, n = w_shape
    stacks = math.prod(lead) if lead else 1
    per_stack = 4 * n * (1 + 1 + policy.groups)  # sum_qw + c0 + c
    if has_bias:
        per_stack += 4 * n
    total = n_elem + stacks * per_stack
    if policy.backend == "pallas" and policy.is_approx and policy.groups == 1:
        from repro_torch.quant.quantize import (EPI_ROWS, META_LEN,
                                                serving_blocks)

        bn, bk = serving_blocks(k, n)
        kb, nb = -(-k // bk) * bk, -(-n // bn) * bn
        total += stacks * (kb * nb + 4 * (EPI_ROWS * nb + META_LEN))
    else:
        total += stacks * _fold_bytes(k, n, policy)
    return total


def _fold_bytes(k: int, n: int, policy: ApproxPolicy) -> int:
    """Bytes of the folded float32 operands (``build_fold``'s eligibility
    and shapes: A (k, n), the mode's B slice, delta (n,))."""
    from repro_torch.core.multipliers import _F32_EXACT_K

    if policy.groups != 1 or k > _F32_EXACT_K:
        return 0
    b_rows = 0
    if policy.is_approx:
        if policy.mode in ("perforated", "recursive"):
            b_rows = k
        elif policy.mode == "truncated":
            b_rows = policy.m * k + (k if policy.use_cv else 0)
    return 4 * ((k + b_rows) * n + n)


def plan_entry(path: str, node: dict, policy: ApproxPolicy | None,
               rule: str, n_array: int = 64) -> PlanEntry:
    """One entry from a linear leaf (real tensors or ``meta`` ones)."""
    from repro_torch.core.cost_model import power_saving

    w_shape = tuple(int(s) for s in node["w"].shape)
    has_bias = node.get("b") is not None
    saving = (power_saving(policy.mode, policy.m, n_array)
              if policy is not None and policy.is_approx else 0.0)
    return PlanEntry(path=path, policy=policy, rule=rule, w_shape=w_shape,
                     has_bias=has_bias,
                     packed_bytes=_packed_bytes(w_shape, policy, has_bias),
                     power_saving_pct=round(saving, 2))


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """The resolved assignment table for one parameter tree."""

    spec_name: str
    entries: tuple[PlanEntry, ...]

    def policy_for(self, path: tuple[str, ...] | str) -> ApproxPolicy | None:
        joined = path if isinstance(path, str) else "/".join(path)
        for e in self.entries:
            if e.path == joined:
                return e.policy
        return None

    @property
    def packed(self) -> tuple[PlanEntry, ...]:
        return tuple(e for e in self.entries if e.policy is not None)

    @property
    def total_packed_bytes(self) -> int:
        return sum(e.packed_bytes for e in self.entries)

    def to_dict(self) -> dict:
        return {"spec_name": self.spec_name,
                "entries": [e.to_dict() for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "PackPlan":
        return cls(spec_name=d["spec_name"],
                   entries=tuple(PlanEntry.from_dict(e) for e in d["entries"]))

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "PackPlan":
        return cls.from_dict(json.loads(s))

    def table(self) -> str:
        """Human-readable assignment table (the ``plan`` CLI output)."""
        rows = [("layer", "numerics", "rule", "w shape", "bytes", "power-%")]
        for e in self.entries:
            rows.append((e.path, e.label, e.rule,
                         "x".join(str(s) for s in e.w_shape),
                         f"{e.packed_bytes:,}",
                         f"-{e.power_saving_pct:.1f}" if e.power_saving_pct
                         else "0.0"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        lines.insert(1, "  ".join("-" * w for w in widths))
        lines.append(f"[{self.spec_name}] {len(self.packed)} packed / "
                     f"{len(self.entries) - len(self.packed)} float layers, "
                     f"{self.total_packed_bytes:,} bytes total")
        return "\n".join(lines)


def apply_numerics(params: Any, plan: PackPlan,
                   act_ranges: dict | None = None,
                   default_range: tuple[float, float] = (-8.0, 8.0),
                   strict: bool = True, fuse: bool = True,
                   fold: bool = True) -> Any:
    """Execute a plan: float params -> packed params.  With ``strict`` the
    plan must cover exactly the packable layers of ``params``; ``fuse`` and
    ``fold`` pass through to ``pack_params`` (``fold=False`` keeps every
    pack off the folded operands, on the exact-integer path)."""
    from repro_torch.core.approx_linear import is_linear_params, pack_params

    want = {e.path: e.policy for e in plan.entries}
    if strict:
        have: set[str] = set()

        def walk(node: Any, path: tuple[str, ...]):
            if is_linear_params(node):
                have.add("/".join(path))
            elif isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))

        walk(params, ())
        if have != set(want):
            raise ValueError(
                f"plan [{plan.spec_name}] does not match the parameter tree: "
                f"plan-only layers {sorted(set(want) - have)[:5]}, "
                f"unplanned layers {sorted(have - set(want))[:5]}")
    return pack_params(params, lambda p: want.get("/".join(p)),
                       act_ranges=act_ranges, default_range=default_range,
                       fuse=fuse, fold=fold)
