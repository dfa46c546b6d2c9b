"""End-to-end training run (port of ``examples/train_lm.py``): train a
~100M-parameter LM for a few hundred steps on the synthetic stream, with
the full production stack: sharded loader, AdamW, checkpoint/restart,
straggler monitoring.

The default is a 100M-class config (12L x 768, vocab 8192, float32);
``--small`` trains olmo-1b-reduced.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --small \\
        --steps 60 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import ShardedLoader, SyntheticLMConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.examples import example_device
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.runtime import RetryPolicy, StragglerMonitor, run_resilient

#: checkpoint cadence, the reference's
CHECKPOINT_EVERY = 50


def train_lm_config(small: bool = False):
    """olmo-1b-reduced (``small``) or the ~100M model: olmo-1b at 12 x
    768, 12 heads of 64, d_ff 3072, vocab 8192, float32, no remat."""
    if small:
        return get_config("olmo-1b-reduced")
    return dataclasses.replace(
        get_config("olmo-1b"), name="olmo-100m", n_layers=12, d_model=768,
        n_heads=12, kv_heads=12, head_dim=64, d_ff=3072, vocab=8192,
        compute_dtype="float32", remat="none")


def example_configs(cfg, steps: int, batch: int = 8, seq: int = 256
                    ) -> tuple[TrainConfig, SyntheticLMConfig]:
    """The example's optimizer schedule and synthetic stream."""
    tcfg = TrainConfig(base_lr=3e-3, warmup_steps=20, total_steps=steps)
    dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=seq, batch=batch,
                             markov_states=64)
    return tcfg, dcfg


def train_lm(cfg, tcfg: TrainConfig, dcfg: SyntheticLMConfig, ckpt_dir: str,
             device, params=None, codec: str | None = None,
             out=print) -> dict:
    """``tcfg.total_steps`` steps of ``make_train_step`` on ``lm_batch``'s
    stream through ``run_resilient`` (a ``CheckpointManager`` in
    ``ckpt_dir`` with shards under ``codec``, a checkpoint every
    CHECKPOINT_EVERY steps and at the end; a run resumes from the latest
    one there), from ``params`` (default: the seeded init) on ``device``.
    Returns each step's loss and seconds (the loss read back, so the step
    is done), the wall seconds, the flagged stragglers, the checkpoint
    steps kept and the final state."""
    step_fn = make_train_step(cfg, tcfg, device=device)
    monitor = StragglerMonitor()
    manager = CheckpointManager(ckpt_dir, codec=codec)
    loader = ShardedLoader(lambda s, sh, ns: lm_batch(dcfg, s, sh, ns))
    losses: list[float] = []
    step_s: list[float] = []

    def wrapped(state, batch, step):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if step % 20 == 0:
            out(f"step {step:4d}  loss {losses[-1]:.4f}")
        return state

    t0 = time.time()
    try:
        state = run_resilient(
            init_state=lambda: init_train_state(cfg, tcfg, seed=0,
                                                device=device, params=params),
            step_fn=wrapped,
            loader=loader,
            manager=manager,
            total_steps=tcfg.total_steps,
            policy=RetryPolicy(checkpoint_every=CHECKPOINT_EVERY),
            monitor=monitor,
        )
    finally:
        loader.close()
    return {"losses": losses, "step_s": step_s,
            "seconds": time.time() - t0, "flagged": monitor.flagged,
            "checkpoints": manager.steps(), "state": state}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    cfg = train_lm_config(args.small)
    print(f"arch={cfg.name}  ~{cfg.param_count() / 1e6:.0f}M params")
    tcfg, dcfg = example_configs(cfg, args.steps, args.batch, args.seq)
    res = train_lm(cfg, tcfg, dcfg, args.ckpt_dir, dev)
    losses = res["losses"]
    print(f"\n{args.steps} steps in {res['seconds']:.0f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"stragglers flagged: {len(res['flagged'])}; "
          f"checkpoints at {args.ckpt_dir}")


if __name__ == "__main__":
    main()
