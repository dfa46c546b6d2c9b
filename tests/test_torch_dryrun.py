"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``,
``op_count``) and the registry's shapes against the reference's.

- ``SHAPES``, ``shape_applicable``, ``input_specs`` (shapes; the port's
  token ids are int64) and ``model_flops_estimate`` equal the reference's
  for every (arch, shape).
- The op count's FLOPs for olmo-1b-reduced's train step against the
  reference's ``analyze_hlo`` of the same step compiled for one device:
  within 10%.  Both count a dot as 2 x M x N x K and an elementwise op as
  one flop an element; what differs is which elementwise work exists (XLA
  fuses and simplifies the compiled program; eager PyTorch runs every op,
  its backward included, as written), which the matmuls outweigh at a
  128-token batch.
- A hand-written kernel's reckoned work is the bound formula
  ``chip_smoke.py`` uses, call by call.
- A production cell's record has the reference's keys.
"""

import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.launch import roofline as jroof
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.configs.registry import list_archs
from repro_torch.core.approx_linear import LayerStack, QuantizedDense
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch import dryrun, op_count, roofline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.models import build_model
from repro_torch.models import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in sorted(jax_list_archs()) for s in jreg.SHAPES]


def test_archs_and_shapes_equal_reference():
    assert list_archs() == sorted(jax_list_archs())
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch)
            for k, v in treg.SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch)
        for k, v in jreg.SHAPES.items()}


def _shapes(tree) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (int,)) or getattr(node, "ndim", 1) == 0:
            out["/".join(path)] = ()
        else:
            out["/".join(path)] = tuple(node.shape)

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_flops_and_skips_equal_reference(arch, shape):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert treg.shape_applicable(tcfg, shape) == jreg.shape_applicable(
        jcfg, shape)
    s = treg.SHAPES[shape]
    assert roofline.model_flops_estimate(
        tcfg, s.kind, s.seq_len, s.global_batch) == \
        jroof.model_flops_estimate(jcfg, s.kind, s.seq_len, s.global_batch)
    if not treg.shape_applicable(tcfg, shape)[0]:
        return
    got, want = treg.input_specs(tcfg, shape), jreg.input_specs(jcfg, shape)
    assert _shapes(got) == _shapes(want)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype,
                                                     jnp.floating):
            key = [getattr(k, "key", k) for k in path]
            node = got
            for k in key:
                node = node[k]
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), key


def _olmo_train_step():
    from repro.launch.train import TrainConfig as JTrainConfig
    from repro.launch.train import init_train_state as jinit
    from repro.launch.train import make_train_step as jstep
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)

    arch = "olmo-1b-reduced"
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    b, t = 4, 32
    jstate = jax.eval_shape(lambda: jinit(jcfg, JTrainConfig(),
                                          jax.random.PRNGKey(0)))
    jbatch = {k: jax.ShapeDtypeStruct((b, t), jnp.int32)
              for k in ("tokens", "labels")}
    compiled = jax.jit(jstep(jcfg, JTrainConfig())).lower(
        jstate, jbatch).compile()
    state = init_train_state(tcfg, TrainConfig(), device="meta")
    step = make_train_step(tcfg, TrainConfig(), device="meta")
    batch = {k: torch.empty((b, t), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    count, _ = op_count.count(step, state, batch)
    return compiled, count


def test_op_count_flops_vs_reference_hlo_analysis():
    from repro.launch.hlo_analysis import analyze_hlo

    compiled, count = _olmo_train_step()
    want = analyze_hlo(compiled.as_text()).flops
    got = count.terms().flops
    assert abs(got / want - 1) < 0.10, (got, want)
    assert count.collective_counts == {} and count.kernels == {}


def test_kernel_work_is_chip_smokes_bound_formula():
    """Every approx call of a packed olmo-1b-reduced prefill, traced on
    ``meta``, is counted by ``roofline.approx_matmul_work`` of its shapes,
    the function ``chip_smoke.py``'s bound goes through."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    cfg = get_config("olmo-1b-reduced")
    params = build_serving_params(
        build_model(cfg, "meta").init(0), cfg, ServeConfig(policy=ApproxPolicy(
            "perforated", 2, use_cv=True, backend="pallas")), device="meta")
    api = build_model(cfg, "meta")
    b, t = 2, 64
    tokens = torch.empty((b, t), dtype=torch.int64, device="meta")
    count, _ = op_count.count(lambda p, x: api.prefill(p, {"tokens": x}, t),
                              params, tokens)
    want_bytes = want_ops = calls = 0.0

    def packs(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from packs(v)
        elif isinstance(node, (list, LayerStack)):
            for v in (node.layers if isinstance(node, LayerStack) else node):
                yield from packs(v)
        elif isinstance(node, torch.nn.Module) and node.blocked is not None:
            yield node

    for mod in packs(params):
        rows = 1 if isinstance(mod, QuantizedDense) and \
            mod.blocked.n == cfg.vocab else b * t  # the head: last token
        blk = mod.blocked
        nb, ops = roofline.approx_matmul_work(
            rows, blk.k, blk.n, blk.w_qbt.numel(), blk.epilogue.numel(),
            blk.meta.numel(), 4, 4, "perforated", 2)
        want_bytes, want_ops, calls = want_bytes + nb, want_ops + ops, \
            calls + 1
    work = count.kernels["approx_matmul_cv_fused"]
    assert (work.calls, work.bytes, work.ops) == (calls, want_bytes,
                                                  want_ops)
    # chip_smoke.py bounds its measured times with the same formula
    got = chip_smoke.approx_bound(128, 2048, 8192, 2048 * 8192, 8 * 8192, 8,
                                  2, 2, "H100 80GB HBM3")
    nb, ops = roofline.approx_matmul_work(128, 2048, 8192, 2048 * 8192,
                                          8 * 8192, 8, 2, 2, "perforated", 2)
    assert got == roofline.bound(nb, ops, roofline.PEAK_INT8)


def test_production_cell_record_has_the_reference_keys():
    rec = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes"}
    assert set(rec["roofline"]) == {
        "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
        "compute_s", "memory_s", "collective_s", "dominant", "collectives",
        "collective_counts", "raw_cost_analysis"}
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / 256
    assert 0 < rec["useful_flops_ratio"] < 1
    kernels = rec["roofline"]["raw_cost_analysis"]["kernels"]
    assert kernels["approx_matmul_cv_fused"]["calls"] > 0
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k", multi_pod=True)
    assert skip["status"] == "skip" and skip["chips"] == 512


def test_a_cuda_mesh_without_nccl_raises_naming_its_size():
    with pytest.raises(RuntimeError, match="nccl process group of 4 ranks"):
        make_test_mesh((2, 2), device="cuda")
    with pytest.raises(RuntimeError, match="gloo process group of 256"):
        from repro_torch.launch.mesh import make_production_mesh

        make_production_mesh(device="cpu")
    mesh = dryrun.TracingMesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.size == 512 and mesh.dp_axes == ("pod", "data")
