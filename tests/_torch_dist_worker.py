"""The port's side of ``tests/test_torch_distributed.py``: one rank of a
4-rank ``gloo`` group (``torch.multiprocessing.spawn``, ``file://`` init
under the test's temporary directory), running every check and writing
its results to ``rank<r>.pkl``.  Imports only torch and the port."""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.bridge import from_jax_params
from repro_torch.checkpoint import CheckpointManager, restore_with_sharding
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLMConfig, lm_batch
from repro_torch.launch.mesh import TracingMesh, make_test_mesh
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step,
                                      train_state_shardings)
from repro_torch.nn import moe as tmoe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import P, comm, placements, shard
from repro_torch.parallel.sharding import tree_gather, tree_shard
from repro_torch.runtime.overlap import compressed_psum, rs_matmul_overlapped

EPS = 1e-4  # AdamW eps, as tests/test_torch_train.py
STEPS = 2


def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _flat(tree) -> dict:
    out = {}
    tree_map(lambda path, t: out.__setitem__(path, _np(t)), tree)
    return out


def _init(tmp: str, arch: str) -> dict:
    """The reference's initial parameters of ``arch`` (flat numpy), which
    its subprocess writes before it compiles."""
    path = os.path.join(tmp, f"init_{arch}.pkl")
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > 500:
            raise TimeoutError(f"no reference init for {arch}")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _tcfg() -> TrainConfig:
    return TrainConfig(optimizer=tadamw.AdamWConfig(eps=EPS),
                       warmup_steps=0, base_lr=1e-3)


def _cfg(arch: str, sp: bool, ep: bool):
    cfg = dataclasses.replace(get_config(arch), sequence_parallel=sp)
    if ep:
        cfg = dataclasses.replace(cfg, moe_impl="ep_psum")
    return cfg


def _batches(vocab: int):
    dcfg = SyntheticLMConfig(vocab=vocab, seq_len=16, batch=4)
    return [lm_batch(dcfg, i) for i in range(STEPS)]


def train_check(inp, mesh, arch, sp, ep, out) -> None:
    """STEPS sharded steps from the reference's init against the
    unsharded step on the same batches (non-EP archs)."""
    cfg, tcfg = _cfg(arch, sp, ep), _tcfg()
    params = from_jax_params(_init(inp["tmp"], arch), cfg)
    state = init_train_state(cfg, tcfg, device="cpu", params=params)
    sh = train_state_shardings(cfg, tcfg, mesh)
    local = tree_shard(state, sh, mesh)
    step = make_train_step(cfg, tcfg, device="cpu", mesh=mesh,
                           param_sh=sh["params"])
    plain = make_train_step(dataclasses.replace(cfg, moe_impl="local"),
                            tcfg, device="cpu")
    losses, plain_losses = [], []
    for b in _batches(cfg.vocab):
        local, m = step(local, b)
        losses.append(float(m["loss"]))
        if not ep:
            state, mu = plain(state, b)
            plain_losses.append(float(mu["loss"]))
    full = tree_gather(local["params"], sh["params"], mesh)
    out[("train", arch, sp)] = {"losses": losses,
                                "plain_losses": plain_losses,
                                "params": _flat(full)}


def compress_check(inp, mesh, out) -> None:
    """int8 error-feedback gradient compression in the sharded step (a
    leaf's absmax over the whole mesh) against the unsharded step."""
    arch = "olmo-1b-reduced"
    cfg = _cfg(arch, False, False)
    tcfg = dataclasses.replace(_tcfg(), grad_compress=True)
    state = init_train_state(cfg, tcfg, device="cpu", params=from_jax_params(
        _init(inp["tmp"], arch), cfg))
    sh = train_state_shardings(cfg, tcfg, mesh)
    local = tree_shard(state, sh, mesh)
    step = make_train_step(cfg, tcfg, device="cpu", mesh=mesh,
                           param_sh=sh["params"])
    plain = make_train_step(cfg, tcfg, device="cpu")
    losses, plain_losses = [], []
    for b in _batches(cfg.vocab):
        local, m = step(local, b)
        state, mu = plain(state, b)
        losses.append(float(m["loss"]))
        plain_losses.append(float(mu["loss"]))
    out["compress"] = {
        "losses": losses, "plain_losses": plain_losses,
        "params": _flat(tree_gather(local["params"], sh["params"], mesh)),
        "plain_params": _flat(state["params"]),
        "ef": _flat(tree_gather(local["ef"], sh["ef"], mesh))}


def collective_check(inp, mesh, out) -> None:
    """One sharded olmo-1b step (sequence parallel): the collectives it
    issues, by the port's counter and by CommDebugMode, against the dry
    run's reckoning of the same step on a TracingMesh."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import op_count

    arch = "olmo-1b-reduced"
    cfg, tcfg = _cfg(arch, True, False), _tcfg()
    params = from_jax_params(_init(inp["tmp"], arch), cfg)
    state = init_train_state(cfg, tcfg, device="cpu", params=params)
    sh = train_state_shardings(cfg, tcfg, mesh)
    local = tree_shard(state, sh, mesh)
    step = make_train_step(cfg, tcfg, device="cpu", mesh=mesh,
                           param_sh=sh["params"])
    b = _batches(cfg.vocab)[0]
    comm.reset_counts()
    with CommDebugMode() as cdm:
        step(local, b)
    issued = dict(comm.COUNTS)
    issued_bytes = dict(comm.BYTES)
    debug = {str(k): v for k, v in cdm.get_comm_counts().items()}
    tmesh = TracingMesh((2, 2), ("data", "model"), rank=mesh.rank)
    meta_state = init_train_state(cfg, tcfg, seed=0, device="meta")
    tsh = train_state_shardings(cfg, tcfg, tmesh)
    tstep = make_train_step(cfg, tcfg, device="meta", mesh=tmesh,
                            param_sh=tsh["params"])
    meta_b = {k: torch.as_tensor(v).to("meta") for k, v in b.items()}
    count, _ = op_count.count(lambda s: tstep(s, meta_b),
                              tree_shard(meta_state, tsh, tmesh))
    out["collectives"] = {"issued": issued, "issued_bytes": issued_bytes,
                          "debug": debug,
                          "reckoned": count.collective_counts,
                          "reckoned_bytes": count.collectives}


def ep_check(inp, mesh, out) -> None:
    """EP over "model" on (2, 2): rows on every rank (the serving layout)
    and rows split over "data" (the train step's), with and without
    drops."""
    e = inp["ep"]
    x = torch.from_numpy(e["x"])
    p = tree_map(lambda _, a: torch.from_numpy(a), e["params"])
    res = {}
    for cf in (0.5, 8.0):
        cfg = tmoe.MoEConfig(d_model=32, d_ff_expert=16, n_experts=8,
                             top_k=2, n_shared=1, impl="ep_psum",
                             capacity_factor=cf)
        y = tmoe.moe_apply(p, x, cfg, mesh=mesh.with_batch_axes(()))
        i = mesh.coord["data"]
        y_rows = tmoe.moe_apply(p, x[2 * i:2 * i + 2], cfg,
                                mesh=mesh.with_batch_axes(("data",)))
        local = tmoe.moe_apply(p, x, dataclasses.replace(cfg, impl="local"))
        res[cf] = {"all_rows": _np(y), "my_rows": _np(y_rows),
                   "local": _np(local)}
    out["ep"] = res


def overlap_check(inp, out) -> None:
    """rs_matmul_overlapped on a (4,) "model" mesh from each rank's piece
    of K, compressed_psum of the same tree on every rank."""
    o = inp["overlap"]
    mesh4 = make_test_mesh((4,), ("model",), device="cpu")
    r = mesh4.coord["model"]
    x, w = torch.from_numpy(o["x"]), torch.from_numpy(o["w"])
    comm.reset_counts()
    y = rs_matmul_overlapped(x[:, 4 * r:4 * r + 4], w[4 * r:4 * r + 4],
                             mesh4, "model")
    hops = comm.COUNTS["collective-permute"]
    grads = {k: torch.from_numpy(v) for k, v in o["grads"].items()}
    g = compressed_psum(grads, mesh4, "model")
    out["overlap"] = {"y": _np(y), "hops": hops,
                      "psum": {k: _np(v) for k, v in g.items()}}


def remesh_check(inp, mesh, tmp, out) -> None:
    """The olmo-1b train state saved sharded under (2, 2) and unsharded;
    restored under (4, 1); the reference's elastic tree the same way."""
    arch = "olmo-1b-reduced"
    cfg, tcfg = _cfg(arch, False, False), _tcfg()
    state = init_train_state(cfg, tcfg, device="cpu", params=from_jax_params(
        _init(inp["tmp"], arch), cfg))
    sh = train_state_shardings(cfg, tcfg, mesh)
    local = tree_shard(state, sh, mesh)
    sharded_dir, plain_dir = (os.path.join(tmp, "ck_sharded"),
                              os.path.join(tmp, "ck_plain"))
    CheckpointManager(sharded_dir).save(local, 3, shardings=sh, mesh=mesh)
    if mesh.rank == 0:
        CheckpointManager(plain_dir).save(state, 3)
    dist.barrier()
    mesh_b = make_test_mesh((4, 1), device="cpu")
    sh_b = train_state_shardings(cfg, tcfg, mesh_b)
    template = init_train_state(cfg, tcfg, seed=0, device="meta")
    restored, step = restore_with_sharding(CheckpointManager(sharded_dir),
                                           template, sh_b, mesh=mesh_b)
    want = {}
    tree_map(lambda path, t: want.__setitem__(path, t),
             tree_shard(state, sh_b, mesh_b))
    got = {}
    tree_map(lambda path, t: got.__setitem__(path, t), restored)
    equal = set(got) == set(want) and all(
        torch.equal(got[k], v) if torch.is_tensor(v) else got[k] == v
        for k, v in want.items())
    sharded = [s for s in tree_leaves(sh_b["params"]) if any(s)]
    # the reference's own elastic case
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8)}
    sh_a = {"w": P("data", "model"), "b": P("model")}
    d3 = os.path.join(tmp, "ck_elastic")
    CheckpointManager(d3).save(tree_shard(tree, sh_a, mesh), 3,
                               shardings=sh_a, mesh=mesh)
    sh_b2 = {"w": P("data", "model"), "b": P()}
    got, step2 = restore_with_sharding(
        CheckpointManager(d3), {"w": torch.zeros(8, 8), "b": torch.zeros(8)},
        sh_b2, mesh=mesh_b)
    elastic = (step2 == 3 and torch.equal(got["w"], tree["w"][
        2 * mesh_b.coord["data"]:2 * mesh_b.coord["data"] + 2])
        and torch.equal(got["b"], tree["b"]))
    out["remesh"] = {"step": step, "equal": equal, "n_sharded": len(sharded),
                     "elastic": elastic, "dirs": (sharded_dir, plain_dir)}


def placements_check(mesh, out) -> None:
    """DTensor's local piece under ``placements(spec)`` equals
    ``shard(x, spec)``."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    res = {}
    for spec in (P("data", "model"), P("model", "data"), P(None, "model"),
                 P(("data", "model"), None), P(None, ("data", "model")),
                 P()):
        dt = distribute_tensor(x, mesh.device_mesh, placements(spec, mesh))
        res[str(spec)] = torch.equal(dt.to_local(), shard(x, spec, mesh))
    out["placements"] = res


def run(rank: int, world: int, tmp: str, inp_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    inp["tmp"] = tmp
    out: dict = {}
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    checks = [("placements", lambda: placements_check(mesh, out)),
              ("ep", lambda: ep_check(inp, mesh, out)),
              ("overlap", lambda: overlap_check(inp, out)),
              ("collectives", lambda: collective_check(inp, mesh, out)),
              ("compress", lambda: compress_check(inp, mesh, out)),
              ("remesh", lambda: remesh_check(inp, mesh, tmp, out))]
    for arch, sp, ep in inp["train_cases"]:
        checks.append((f"train {arch}",
                       lambda a=arch, s=sp, e=ep: train_check(
                           inp, mesh, a, s, e, out)))
    errors = {}
    for name, fn in checks:
        try:
            fn()
        except Exception:  # reported by the test that reads it
            errors[name] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"out": out, "errors": errors}, f)
    dist.barrier()
    dist.destroy_process_group()

