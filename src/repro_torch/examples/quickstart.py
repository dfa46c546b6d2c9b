"""Quickstart: the paper's technique in 40 lines (port of
``examples/quickstart.py``).

Trains nothing: takes a small randomly initialized transformer, describes
the numerics declaratively (NumericsSpec -> PackPlan -> apply), packs it
for an approximate-multiplier MAC array (uint8 codes + control-variate
constants), and shows the CV recovering the logits that aggressive
approximation destroys.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.policy import ApproxPolicy
from repro_torch.examples import example_device
from repro_torch.launch.serve import (ServeConfig, _to_device,
                                     build_serving_params)
from repro_torch.models import build_model
from repro_torch.numerics import get_preset

#: (mode, m, use_cv) of each row, the reference's
POINTS = [
    ("exact", 0, True),          # plain int8 quantization
    ("perforated", 3, False),    # aggressive approximation, no correction
    ("perforated", 3, True),     # the paper: + control variate
    ("recursive", 4, False),
    ("recursive", 4, True),
    ("truncated", 6, False),
    ("truncated", 6, True),
]


def quickstart_config(arch: str = "olmo-1b-reduced"):
    """The example's model: ``arch`` at float32."""
    return dataclasses.replace(get_config(arch), compute_dtype="float32")


@torch.no_grad()
def quickstart(cfg, params, tokens: torch.Tensor, device
               ) -> tuple[str, list[tuple[str, float]]]:
    """(the ``serve-default`` plan table of ``params``, (policy label, mean
    |logit err| against the float forward) of each of POINTS), on
    ``device``."""
    api = build_model(cfg, device)
    batch = {"tokens": tokens.to(api.device)}
    ref = api.forward(params, batch)  # float reference
    # the spec is declarative and serializable: audit the per-layer plan
    # before packing anything (the `plan` subcommand's table)
    table = get_preset("serve-default").resolve(params).table()
    rows = []
    for mode, m, cv in POINTS:
        policy = ApproxPolicy(mode, m, use_cv=cv)
        spec = get_preset("serve-default", policy=policy)
        packed = build_serving_params(params, cfg, ServeConfig(spec=spec),
                                      device=api.device)
        logits = api.forward(packed, batch)
        rows.append((policy.label(), float((logits - ref).abs().mean())))
        del packed, logits
    return table, rows


def example_inputs(cfg) -> tuple[dict, torch.Tensor]:
    """``main``'s seeded init and (4, 32) tokens, made on the host, so that
    the card and the host start from the same numbers."""
    params = build_model(cfg, "cpu").init(0)
    toks = torch.randint(0, cfg.vocab, (4, 32),
                         generator=torch.Generator().manual_seed(1))
    return params, toks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    cfg = quickstart_config()
    params, toks = example_inputs(cfg)
    table, rows = quickstart(cfg, _to_device(params, dev), toks, dev)
    print(table)
    print()
    print(f"{'numerics':34s} {'mean |logit err|':>18s}")
    for label, err in rows:
        print(f"{label:34s} {err:18.4f}")


if __name__ == "__main__":
    main()
