"""PyTorch/CUDA port of the approximate-multiplier inference system.

The package mirrors ``repro`` (the JAX reference) module by module and
imports nothing of it.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU; every approximate linear layer of a
``backend: "pallas"`` pack runs the hand-written Hopper kernel in
:mod:`repro_torch.kernels.approx_matmul`.
"""

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def seeded_generator(device, seed: int) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``; None on the
    ``meta`` device, whose tensors have shapes and no values (the ``plan``
    subcommand builds its parameter tree there)."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)
