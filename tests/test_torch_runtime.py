"""The port's runtime, loader and train CLI against the JAX package: the
counterparts of tests/test_fault_tolerance.py and of the loader tests in
tests/test_data_optim.py; a training checkpoint written by the JAX
package's resilient loop resumed by the port's; the port's loop with
injected failures against its clean run; the train CLI resuming; and
``plan --diff-checkpoint`` against the JAX CLI.

Tolerances: the restored state bit for bit; the first resumed step's
loss within rtol 1e-5 of JAX's for that step (float32 sums in another
order; later steps are not compared at AdamW's eps 1e-8, see
tests/test_torch_train.py); the port's runs with and without failures
bit for bit.  Every test that starts a thread (the loader's, the
heartbeat's, an async save's) closes it in ``finally`` and fails if it
is still alive after a join with a timeout.
"""

import contextlib
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.checkpoint.manager import _flatten
from repro.configs import get_config as jax_get_config
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.data import ShardedLoader as JaxLoader
from repro.data.synthetic import SyntheticLMConfig as JaxDataConfig
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.launch import serve as jserve
from repro.launch.train import TrainConfig as JaxTrainConfig
from repro.launch.train import init_train_state as jax_init_train_state
from repro.launch.train import make_train_step as jax_make_train_step
from repro.numerics import get_preset as jax_get_preset
from repro.runtime import run_resilient as jax_run_resilient
from repro.runtime import RetryPolicy as JaxRetryPolicy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _walk
from repro_torch.configs import get_config
from repro_torch.data import ShardedLoader, SyntheticLMConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      main as train_main, make_train_step)
from repro_torch.runtime import (Heartbeat, RetryPolicy, StragglerMonitor,
                                 run_resilient)

from _torch_port import jax_side

ARCH = "olmo-1b-reduced"
#: layers whose assignment differs between int8 and serve-default
#: (perforated m=2 + CV on the approx kernel) on full-size olmo-1b: the
#: count chip_smoke.py's checkpoint phase expects from ``plan --preset
#: int8 --diff-checkpoint``
OLMO_INT8_DRIFT = 7
JOIN_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side (as tests/test_torch_train.py:
    torch's pool costs more than it saves on these models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _joined(thread) -> None:
    if thread is not None:
        thread.join(JOIN_S)
        assert not thread.is_alive(), "a thread outlived its join"


@contextlib.contextmanager
def _loader(batch_fn, **kw):
    loader = ShardedLoader(batch_fn, **kw)
    try:
        yield loader
    finally:
        thread = loader._thread
        loader.close()
        _joined(thread)


def _step_loader():
    return _loader(lambda step, shard, n: {
        "x": torch.full((2,), float(step))})


# ---------------------------------------------------------------------------
# the counterparts of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------


def test_resilient_loop_recovers_from_failures():
    """Two injected crashes; the state (a log of consumed step values)
    equals the clean run's: every step counted once, from checkpoints."""
    crashes = {7, 13}

    def failure_hook(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError("injected node failure")

    def step_fn(state, batch, step):
        assert batch["x"][0] == step, "loader must resume deterministically"
        return {"sum": state["sum"] + batch["x"][0],
                "count": state["count"] + 1}

    with tempfile.TemporaryDirectory() as d, _step_loader() as loader:
        mgr = CheckpointManager(d)
        try:
            final = run_resilient(
                init_state=lambda: {"sum": torch.zeros(()), "count": 0},
                step_fn=step_fn, loader=loader, manager=mgr, total_steps=20,
                policy=RetryPolicy(max_failures=5, checkpoint_every=5,
                                   backoff_s=0.01),
                failure_hook=failure_hook)
        finally:
            _joined(mgr._thread)
    assert not crashes
    assert float(final["sum"]) == sum(range(20))
    assert final["count"] == 20 and isinstance(final["count"], int)


def test_resilient_loop_gives_up_after_max_failures():
    def failure_hook(step):
        raise RuntimeError("permanently broken")

    with tempfile.TemporaryDirectory() as d, _step_loader() as loader:
        mgr = CheckpointManager(d)
        with pytest.raises(RuntimeError, match="permanently"):
            run_resilient(
                init_state=lambda: {"n": 0},
                step_fn=lambda s, b, i: {"n": s["n"] + 1},
                loader=loader, manager=mgr, total_steps=5,
                policy=RetryPolicy(max_failures=2, backoff_s=0.01),
                failure_hook=failure_hook)
        assert mgr.steps() == []


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, warmup=3)
    for i in range(10):
        assert not mon.record(i, 0.1 + 0.001 * (i % 3))
    assert mon.record(10, 0.5)  # 5x the EMA
    assert mon.flagged and mon.flagged[0][0] == 10
    # a straggler must not poison the EMA
    assert abs(mon.ema - 0.1) < 0.02


def test_heartbeat_ages():
    with tempfile.TemporaryDirectory() as d:
        hb = Heartbeat(f"{d}/hb", interval_s=0.05).start()
        try:
            time.sleep(0.12)
            assert hb.age() < 0.2
        finally:
            hb.stop()
            _joined(hb._thread)
        time.sleep(0.15)
        assert hb.age() >= 0.1
    assert Heartbeat(f"{d}/none").age() == float("inf")


# ---------------------------------------------------------------------------
# the loader (tests/test_data_optim.py)
# ---------------------------------------------------------------------------


def test_loader_skip_to_resume_equals_reference():
    """The port's loader gives the reference's batches, resumes at
    ``skip_to`` and restarts its thread after it."""
    cfg = SyntheticLMConfig(vocab=64, seq_len=16, batch=2)
    jcfg = JaxDataConfig(vocab=64, seq_len=16, batch=2)
    jl = JaxLoader(lambda s, sh, ns: jax_lm_batch(jcfg, s, sh, ns),
                   shard=0, n_shards=1)
    try:
        want = [next(jl)["tokens"] for _ in range(4)]
    finally:
        jl.close()
    with _loader(lambda s, sh, ns: lm_batch(cfg, s, sh, ns)) as loader:
        seq = [next(loader)["tokens"] for _ in range(4)]
        loader.skip_to(2)
        again = next(loader)["tokens"]
        loader.skip_to(0)
        first = next(loader)["tokens"]
    for a, b in zip(seq, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again, seq[2])
    np.testing.assert_array_equal(first, seq[0])


def test_loader_shards_are_disjoint():
    """Each shard gets its own batch for a step, and the defaults are
    shard 0 of 1 without a process group."""
    cfg = SyntheticLMConfig(vocab=512, seq_len=32, batch=2)
    seen = []
    for shard in range(3):
        with _loader(lambda s, sh, ns: {**lm_batch(cfg, s, sh, ns),
                                        "who": np.array([sh, ns])},
                     shard=shard, n_shards=3) as loader:
            batch = next(loader)
        assert batch["who"].tolist() == [shard, 3]
        seen.append(batch["tokens"])
    assert not np.array_equal(seen[0], seen[1])
    assert not np.array_equal(seen[1], seen[2])
    with _loader(lambda s, sh, ns: {"who": np.array([sh, ns])}) as loader:
        assert next(loader)["who"].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# training checkpoints across the packages, failures, the CLI
# ---------------------------------------------------------------------------

B, T = 2, 16


def _dcfg(vocab: int) -> SyntheticLMConfig:
    return SyntheticLMConfig(vocab=vocab, seq_len=T, batch=B)


def _port_loop(d: str, total: int, failures=(), every: int = 2):
    """The port's resilient loop at olmo-1b-reduced on the CPU: (the state
    it started its first step from, each step's last loss, the final
    state, the state restored from its last checkpoint)."""
    cfg = get_config(ARCH)
    tcfg = TrainConfig(base_lr=1e-3, total_steps=8)
    step = make_train_step(cfg, tcfg, device="cpu")
    losses, first = {}, []
    pending = set(failures)

    def wrapped(state, batch, i):
        if not first:
            first.append(state)
        state, m = step(state, batch)
        losses[i] = float(m["loss"])
        return state

    def hook(i):
        if i in pending:
            pending.discard(i)
            raise RuntimeError("injected node failure")

    def init():
        return init_train_state(cfg, tcfg, seed=0, device="cpu")

    mgr = CheckpointManager(d)
    with _loader(lambda s, sh, ns: lm_batch(_dcfg(cfg.vocab), s, sh,
                                            ns)) as loader:
        try:
            final = run_resilient(
                init_state=init, step_fn=wrapped, loader=loader, manager=mgr,
                total_steps=total,
                policy=RetryPolicy(max_failures=3, backoff_s=0.0,
                                   checkpoint_every=every),
                failure_hook=hook)
        finally:
            _joined(mgr._thread)
    assert not pending
    restored, _ = mgr.restore(init())
    return first[0], losses, final, restored


def _assert_state_equal(a, b):
    fa, fb = list(_walk(a)), list(_walk(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            assert x == y, k


def test_port_resumes_a_jax_training_checkpoint(tmp_path):
    """JAX's resilient loop writes checkpoints for steps 0-3; the port's,
    pointed at the same directory, restores step 3's state bit for bit
    and its first step (step 4) has JAX's loss for it."""
    jcfg = jax_get_config(ARCH)
    jtcfg = JaxTrainConfig(base_lr=1e-3, total_steps=8)
    jstep = jax.jit(jax_make_train_step(jcfg, jtcfg))
    jdata = JaxDataConfig(vocab=jcfg.vocab, seq_len=T, batch=B)

    def jwrapped(state, batch, i):
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        return state

    def jinit():
        return jax_init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))

    jl = JaxLoader(lambda s, sh, ns: jax_lm_batch(jdata, s, sh, ns),
                   shard=0, n_shards=1)
    jm = JaxManager(str(tmp_path))
    try:
        jax_run_resilient(init_state=jinit, step_fn=jwrapped, loader=jl,
                          manager=jm, total_steps=4,
                          policy=JaxRetryPolicy(checkpoint_every=2))
    finally:
        jl.close()
    assert jm.steps() == [1, 3]
    jstate, _ = jm.restore(jinit())
    _, want = jstep(jstate, {k: jnp.asarray(v) for k, v in
                             jax_lm_batch(jdata, 4).items()})

    start, losses, _, _ = _port_loop(str(tmp_path), total=6)
    assert sorted(losses) == [4, 5]
    assert start["opt"]["step"] == 4 and isinstance(start["opt"]["step"], int)
    got = {k: v for k, v in _walk(start)}
    ref = dict(_flatten(jstate)[0])
    assert set(got) == set(ref)
    for k, arr in ref.items():
        if k == "opt/step":
            assert int(arr) == got[k]
            continue
        t = got[k]
        assert str(arr.dtype) == str(t.dtype).removeprefix("torch."), k
        assert t.numpy().tobytes() == np.asarray(arr).tobytes(), k
    assert losses[4] == pytest.approx(float(want["loss"]), rel=1e-5)


def test_port_loop_with_failures_equals_clean_run(tmp_path):
    """Failures at steps 3 and 6 (each restores the last checkpoint and
    replays): every step's loss and the final state equal the clean
    run's, bit for bit, and so does the last checkpoint."""
    _, clean_l, clean, clean_ck = _port_loop(str(tmp_path / "a"), total=8)
    _, l, final, ck = _port_loop(str(tmp_path / "b"), total=8,
                                 failures=(3, 6))
    assert l == clean_l and sorted(l) == list(range(8))
    _assert_state_equal(final, clean)
    _assert_state_equal(ck, clean_ck)
    _assert_state_equal(ck, final)
    assert final["opt"]["step"] == 8


def test_train_cli_runs_on_the_cpu_and_resumes(tmp_path, capsys):
    """The reference's flags plus ``--device cpu``: a 3-step run, then a
    5-step run in the same directory resumes after step 2 (no step 0
    line, checkpoints of steps 3 and 4 added)."""
    args = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    train_main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     0  loss " in out and "done: 3 steps in" in out
    assert "stragglers=" in out
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2]
    train_main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "step     0" not in out and "done: 5 steps in" in out
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3, 4]


# ---------------------------------------------------------------------------
# plan --diff-checkpoint against the JAX CLI
# ---------------------------------------------------------------------------


def _both(argv, capsys):
    """(output, exit code) of the port's and the JAX CLI's ``plan``."""
    out = []
    for fn in (serve_main, jserve.main):
        code = 0
        try:
            fn(argv)
        except SystemExit as e:
            code = e.code
        out.append((capsys.readouterr().out, code))
    return out


def test_plan_diff_checkpoint_gate(tmp_path, capsys):
    """The counterpart of tests/test_speculative.py's gate on a shard the
    reference's ``save_pytree`` wrote: the same spec returns cleanly, a
    different one exits with the drifted layer count; output byte-equal to
    the JAX CLI's; and the full-size olmo-1b count under ``int8`` against
    serve-default on the approx kernel (shapes on the ``meta`` device)."""
    _, _, raw = jax_side()
    path = str(tmp_path / "ckpt.rpk")
    spec_d = jax_get_preset("serve-default").to_dict()
    jax_save_pytree(raw, path, meta={"numerics": spec_d})
    base = ["plan", "--arch", ARCH, "--diff-checkpoint", path]
    (got, code), want = _both(base + ["--preset", "serve-default"], capsys)
    assert (got, code) == want and code == 0
    assert "plan matches checkpoint: 7 layers, no drift" in got
    (got, code), want = _both(base + ["--preset", "int8"], capsys)
    assert (got, code) == want and code == 7 and "PLAN DRIFT" in got
    (got, code), want = _both(base + ["--preset", "int8", "--json"], capsys)
    assert (got, code) == want and code == 7

    spec = jax_get_preset("serve-default", policy=JaxPolicy(
        "perforated", 2, use_cv=True, backend="pallas"))
    full = str(tmp_path / "full.rpk")
    jax_save_pytree({"w": np.zeros(1, np.float32)}, full,
                    meta={"numerics": spec.to_dict()})
    (got, code), want = _both(["plan", "--arch", "olmo-1b", "--preset",
                               "int8", "--diff-checkpoint", full], capsys)
    assert (got, code) == want and code == OLMO_INT8_DRIFT
    spec_json = tmp_path / "spec.json"
    spec_json.write_text(spec.to_json())
    (got, code), want = _both(["plan", "--arch", "olmo-1b", "--spec-json",
                               str(spec_json), "--diff-checkpoint", full],
                              capsys)
    assert (got, code) == want and code == 0
    none = str(tmp_path / "none.rpk")
    jax_save_pytree({"w": np.zeros(1, np.float32)}, none)
    (got, code), want = _both(base[:-1] + [none, "--preset", "int8"], capsys)
    assert code == want[1] and "carries no numerics spec" in str(code)
