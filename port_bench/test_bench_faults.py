"""A run whose timed path is broken underneath comes out not correct:
each fault a cell can have, planted at a size a CPU test run holds, the
harness's look for a card skipped.  One chip each: no exchange between
chips to leave out."""

import numpy as np
import pytest
import torch

from port_bench import harness, tiny


def state_unchanged(fn):
    """A step that returns the slot cache (its state) unchanged."""
    def step(params, tokens, cache, n_valid, **kw):
        keep = {k: v.clone() for k, v in cache.items()}
        out = fn(params, tokens, cache, n_valid, **kw)
        for k, v in keep.items():
            cache[k].copy_(v)
        return out
    return step


def half_batch(fn):
    """The upper half of the slots left out of the step."""
    def step(params, tokens, cache, n_valid, **kw):
        nv = np.array(n_valid, copy=True)
        nv[len(nv) // 2:] = 0
        logits, cache = fn(params, tokens, cache, nv, **kw)
        # their cursors move as the engine expects, over nothing written
        cache["lengths"][len(nv) // 2:] += torch.as_tensor(
            np.asarray(n_valid)[len(nv) // 2:], dtype=torch.int32)
        return logits, cache
    return step


def head_wrong_row(fn):
    """The head's logits of each slot taken from the next slot's row: each
    served token is still the greedy choice of the row it was read from,
    and is fed back, so the cache agrees with it."""
    def step(params, tokens, cache, n_valid, **kw):
        logits, cache = fn(params, tokens, cache, n_valid, **kw)
        return logits.roll(1, dims=0), cache
    return step


def token_altered(fn):
    """Each token the engine emits moved off its greedy choice where it is
    produced (and fed back as the request's next input)."""
    def emit(r, tok, finished, first):
        return fn(r, tok ^ 1, finished, first)
    return emit


def half_images(fn):
    """Half of the batch left out: its logits the mean over the rest."""
    def fwd(x):
        y = fn(x[: len(x) // 2])
        return torch.cat([y, y.mean(0, keepdim=True).expand_as(y)])
    return fwd


def answer_altered(fn):
    """One logit of each batch's first image moved where it is produced."""
    def fwd(x):
        y = fn(x).clone()
        y[0, 0] += y.abs().max()
        return y
    return fwd


def test_sound_runs_are_correct():
    for name in ("olmo-1b.docs", "resnet44-c10.eval"):
        assert harness.run_cell(tiny.cell(name, seed=99))["correct"] is True


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_engine_faults_are_caught(fault):
    line = harness.run_cell(tiny.cell(
        "olmo-1b.docs", seed=99, hooks={"decode_slots": fault}))
    assert line["correct"] is False, line["checks"]


def test_a_head_on_the_wrong_row_is_caught():
    line = harness.run_cell(tiny.cell(
        "olmo-1b.docs", seed=99, hooks={"decode_slots": head_wrong_row}))
    assert line["correct"] is False, line["checks"]
    c = line["checks"]["logit_decorr"]
    assert c["value"] > c["limit"], line["checks"]


def test_an_altered_token_is_caught():
    line = harness.run_cell(tiny.cell(
        "olmo-1b.docs", seed=99, hooks={"emit_row": token_altered}))
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["token_not_greedy"]["value"] > 0


@pytest.mark.parametrize("fault", [half_images, answer_altered])
def test_cnn_faults_are_caught(fault):
    line = harness.run_cell(tiny.cell(
        "resnet44-c10.eval", seed=99, hooks={"cnn_apply": fault}))
    assert line["correct"] is False, line["checks"]
