"""The port's distributed layer on a 4-rank ``gloo`` CPU group against the
reference on 4 XLA host devices: the sharded training step (with sequence
parallelism), expert-parallel MoE with and without drops, the overlap
collectives, the re-mesh restore, the collectives the step issues against
the dry run's reckoning, and DTensor placements.

One module fixture runs both sides once, concurrently: the reference in
three subprocesses (``--xla_force_host_platform_device_count=4``, as
``tests/test_sharding_dryrun.py`` does; the archs split between them, its
compiles being most of the file's time), handing back numpy; the port in
one 4-rank group (``tests/_torch_dist_worker.py``, ``file://`` init under
the test's temporary directory, so parallel workers never share a port).
Each check is its own test.

Tolerances: the sharded step against the port's unsharded one, losses
rtol 1e-6 (the same float32 sums in other orders); against the reference's sharded step, those of
``tests/test_torch_train.py`` (AdamW eps 1e-4, losses rtol 1e-5,
parameters atol 1e-5).  EP 1e-5, as the reference's EP test.  The
overlapped matmul 1e-5 (float32 chunk sums in ring order).
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (arch, sequence_parallel, expert parallel): the reference's four
#: mini-mesh archs plus olmo-1b
TRAIN = [("olmo-1b-reduced", True, False), ("qwen3-4b-reduced", True, False),
         ("rwkv6-1.6b-reduced", False, False),
         ("hymba-1.5b-reduced", True, False),
         ("deepseek-v2-lite-16b-reduced", True, True)]
WORLD = 4

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_config
    from repro.data.synthetic import SyntheticLMConfig, lm_batch
    from repro.launch.mesh import make_test_mesh, use_mesh
    from repro.launch.train import (TrainConfig, init_train_state,
                                    make_train_step, train_state_shardings)
    from repro.nn import moe as moelib
    from repro.optim import adamw
    from repro.parallel import batch_shardings
    from repro.runtime.overlap import compressed_psum, rs_matmul_overlapped

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    cases, rest = json.loads(sys.argv[3])
    out = {}
    mesh = make_test_mesh((2, 2), ("data", "model"))
    for arch, sp, ep in [inp["train_cases"][i] for i in cases]:
        cfg = dataclasses.replace(get_config(arch), sequence_parallel=sp)
        if ep:
            cfg = dataclasses.replace(cfg, moe_impl="ep_psum")
        tcfg = TrainConfig(optimizer=adamw.AdamWConfig(eps=1e-4),
                           warmup_steps=0, base_lr=1e-3)
        dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=16, batch=4)
        with use_mesh(mesh):
            st_sh = train_state_shardings(cfg, tcfg, mesh)
            state = init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
            # the port's ranks start from these parameters
            path = os.path.join(os.path.dirname(sys.argv[2]),
                                f"init_{arch}.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump({k: np.asarray(v) for k, v in
                             _flatten(state["params"])[0]}, f)
            os.replace(path + ".tmp", path)
            state = jax.device_put(state, st_sh)
            step = make_train_step(cfg, tcfg, mesh=mesh,
                                   param_sh=st_sh["params"])
            losses, jitted = [], None
            for i in range(2):
                b = {k: jnp.asarray(v) for k, v in lm_batch(dcfg, i).items()}
                if jitted is None:
                    jitted = jax.jit(step, in_shardings=(
                        st_sh, batch_shardings(b, mesh)),
                        out_shardings=(st_sh, None))
                state, m = jitted(state, b)
                losses.append(float(m["loss"]))
        out[("train", arch, sp)] = {
            "losses": losses, "params": {k: np.asarray(v) for k, v in
                                         _flatten(state["params"])[0]}}
    if not rest:
        with open(sys.argv[2], "wb") as f:
            pickle.dump(out, f)
        sys.exit(0)
    e = inp["ep"]
    p = jax.tree.map(jnp.asarray, e["params"])
    x = jnp.asarray(e["x"])
    for cf in (0.5, 8.0):
        cfg = moelib.MoEConfig(d_model=32, d_ff_expert=16, n_experts=8,
                               top_k=2, n_shared=1, impl="ep_psum",
                               capacity_factor=cf)
        with use_mesh(mesh):
            y = jax.jit(lambda p, x: moelib.moe_apply(p, x, cfg,
                                                      mesh=mesh))(p, x)
        out[("ep", cf)] = np.asarray(y)
    o = inp["overlap"]
    mesh4 = make_test_mesh((4,), ("model",))
    with use_mesh(mesh4):
        out["rs_matmul"] = np.asarray(jax.jit(
            lambda x, w: rs_matmul_overlapped(x, w, mesh4, "model"))(
                jnp.asarray(o["x"]), jnp.asarray(o["w"])))
        g = compressed_psum({k: jnp.asarray(v) for k, v in o["grads"].items()},
                            mesh4, "model")
        out["compressed_psum"] = {k: np.asarray(v) for k, v in g.items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _inputs() -> dict:
    """Seeded numpy inputs; the train checks' parameters come from the
    reference's own init (its subprocesses write them first)."""
    rng = np.random.default_rng(3)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    ep_params = {"router": {"w": w(32, 8)},
                 "experts": {"gate": {"w": w(8, 32, 16)},
                             "up": {"w": w(8, 32, 16)},
                             "down": {"w": w(8, 16, 32)}},
                 "shared": {"gate": {"w": w(32, 16)}, "up": {"w": w(32, 16)},
                            "down": {"w": w(16, 32)}}}
    return {
        "train_cases": TRAIN,
        "ep": {"params": ep_params,
               "x": rng.standard_normal((4, 12, 32)).astype(np.float32)},
        "overlap": {
            "x": rng.standard_normal((6, 16)).astype(np.float32),
            "w": rng.standard_normal((16, 8)).astype(np.float32),
            "grads": {"a": rng.standard_normal((5, 7)).astype(np.float32),
                      "b": (1e-3 * rng.standard_normal(9)).astype(
                          np.float32)}},
    }


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    inp_path = os.path.join(tmp, "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    parts = [([0, 1], False), ([2, 3], False), ([4], True)]
    refs = [(os.path.join(tmp, f"reference{i}.pkl"), subprocess.Popen(
        [sys.executable, "-c", REFERENCE, inp_path,
         os.path.join(tmp, f"reference{i}.pkl"), json.dumps(part)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for i, part in enumerate(parts)]
    from _torch_dist_worker import run

    ctx = mp.start_processes(run, args=(WORLD, tmp, inp_path),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=300):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    reference = {}
    for ref_path, ref in refs:
        _, err = ref.communicate(timeout=560)
        assert ref.returncode == 0, err[-3000:]
        with open(ref_path, "rb") as f:
            reference.update(pickle.load(f))
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return reference, ranks


def _port(ranks, key: str, name: str | None = None):
    for r in ranks:
        err = r["errors"].get(name or key)
        assert err is None, err
    return [r["out"][key] for r in ranks]


@pytest.mark.parametrize("arch,sp,ep", TRAIN, ids=[a for a, _, _ in TRAIN])
def test_sharded_train_step_vs_unsharded_and_reference(sides, arch, sp, ep):
    reference, ranks = sides
    got = _port(ranks, ("train", arch, sp), f"train {arch}")
    want = reference[("train", arch, sp)]
    mine = got[0]
    if not ep:
        # the port's unsharded step on the same batches (EP with drops is
        # another function: it is held to the reference's alone)
        np.testing.assert_allclose(mine["losses"], mine["plain_losses"],
                                   rtol=1e-6)
    np.testing.assert_allclose(mine["losses"], want["losses"], rtol=1e-5)
    assert set(mine["params"]) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(mine["params"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    for other in got[1:]:  # every rank gathers the same parameters
        assert other["losses"] == mine["losses"]


def test_sharded_step_with_gradient_compression_vs_unsharded(sides):
    """Under int8 gradient compression a gradient summed in another order
    can take the neighbouring code at a rounding tie (as between the two
    packages in ``tests/test_torch_train.py``): losses rtol 1e-5, at most
    1 in 1,000 elements of a leaf beyond 1e-5, by at most 2 lr a step."""
    _, ranks = sides
    res = _port(ranks, "compress")[0]
    np.testing.assert_allclose(res["losses"], res["plain_losses"],
                               rtol=1e-5)
    assert set(res["params"]) == set(res["plain_params"])
    for k, v in res["plain_params"].items():
        diff = np.abs(res["params"][k] - v)
        assert (diff > 1e-5).mean() <= 1e-3, k
        assert diff.max() <= 2 * 1e-3 * 2, k
    assert any(np.abs(e).max() > 0 for e in res["ef"].values())


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_ep_vs_reference_and_local(sides, cf):
    """cf 0.5 drops pairs (the reference's positional rule); cf 8.0 drops
    none and equals the local MoE."""
    reference, ranks = sides
    got = _port(ranks, "ep")
    want = reference[("ep", cf)]
    for r, res in enumerate(got):
        np.testing.assert_allclose(res[cf]["all_rows"], want, atol=1e-5)
        i = (r // 2)  # the rank's "data" coordinate
        np.testing.assert_allclose(res[cf]["my_rows"],
                                   want[2 * i:2 * i + 2], atol=1e-5)
        if cf == 8.0:
            np.testing.assert_allclose(res[cf]["all_rows"],
                                       res[cf]["local"], atol=1e-5)
    if cf == 0.5:
        assert np.abs(got[0][cf]["all_rows"] - got[0][cf]["local"]).max() \
            > 1e-3, "no pair was dropped"


def test_rs_matmul_overlapped_vs_reference(sides):
    reference, ranks = sides
    got = _port(ranks, "overlap")
    for res in got:
        np.testing.assert_allclose(res["y"], reference["rs_matmul"],
                                   atol=1e-5)
        assert res["hops"] == 2 * (WORLD - 1)


def test_compressed_psum_vs_reference(sides):
    reference, ranks = sides
    for res in _port(ranks, "overlap"):
        for k, v in reference["compressed_psum"].items():
            np.testing.assert_allclose(res["psum"][k], v, rtol=1e-6,
                                       atol=1e-9, err_msg=k)


def test_remesh_save_bytes_and_restore_slices(sides):
    """The sharded save's shard file is byte-equal to the unsharded
    save's; the restore under (4, 1) gives every rank its pieces, bit for
    bit, as the reference's elastic test does."""
    _, ranks = sides
    got = _port(ranks, "remesh")
    sharded_dir, plain_dir = got[0]["dirs"]
    name = os.path.join("step_0000000003", "shard_00000.ckpt")
    with open(os.path.join(sharded_dir, name), "rb") as f:
        a = f.read()
    with open(os.path.join(plain_dir, name), "rb") as f:
        b = f.read()
    assert a == b
    assert not os.path.exists(os.path.join(sharded_dir, "step_0000000003",
                                           "shard_00001.ckpt"))
    for res in got:
        assert res["step"] == 3 and res["equal"] and res["elastic"]
        assert res["n_sharded"] > 0


def test_reckoned_collectives_equal_issued(sides):
    """The dry run's reckoning of a sharded olmo-1b step on a (2, 2)
    TracingMesh equals what the step issues on the gloo mesh, kind by
    kind and byte for byte, and CommDebugMode counts the same calls."""
    _, ranks = sides
    names = {"all-gather": "_allgather_base_", "all-reduce": "allreduce_",
             "reduce-scatter": "_reduce_scatter_base_"}
    for res in _port(ranks, "collectives"):
        assert res["issued"] == res["reckoned"]
        assert res["issued_bytes"] == res["reckoned_bytes"]
        debug = {k.split(".")[-1]: v for k, v in res["debug"].items()}
        for kind, n in res["issued"].items():
            assert debug.get(names[kind]) == n, (kind, debug)
        assert set(res["issued"]) == {"all-gather", "all-reduce",
                                      "reduce-scatter"}


def test_placements_give_the_same_pieces(sides):
    _, ranks = sides
    for res in _port(ranks, "placements"):
        assert all(res.values()), res
