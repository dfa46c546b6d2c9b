"""The repo-root examples (``examples/*.py``) as entry points of the port.

Each module keeps its example's flags and defaults, adds ``--device``
(``cuda`` by default; raises without a card) and splits into a function
that takes the config, the weights or data and a device, and a thin
``main`` that makes its own seeded init:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.serve_approx --requests 10
    python -m repro_torch.examples.train_lm --steps 300
    python -m repro_torch.examples.pareto_sweep

The examples keep the default ``backend: "jnp"`` policy, as the reference's
do, so their packs run the plain folded or exact-integer product and no
CUDA kernel.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device


def example_device(device) -> torch.device:
    """``device`` resolved (``cuda`` raises without a card), with TF32 off
    on the card: the examples compute in true float32, and the folded
    products refuse TF32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
