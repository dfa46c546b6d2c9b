"""The port stands alone: no JAX and nothing of the reference package (every
module, the serving layer's telemetry, prom, shadow and fleet included,
the MLA/MoE archs with ``nn.moe`` and ``core.grouped_approx``, the hybrid
with ``nn.ssm``, and the training step with ``optim``, ``data.synthetic``
and ``launch.train``), and its entry points run on the card unless the
caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = {n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_runs_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        from repro_torch.configs import get_config
        from repro_torch.core.policy import ApproxPolicy
        from repro_torch.launch.serve import ServeConfig, build_serving_params
        from repro_torch.models import build_model
        cfg = get_config("olmo-1b-reduced")
        api = build_model(cfg, "cpu")
        params = build_serving_params(api.init(0), cfg, ServeConfig(
            policy=ApproxPolicy("perforated", 2, backend="pallas")),
            device="cpu")
        cache = api.init_slot_cache(2, 16, torch.bfloat16)
        logits, cache = api.decode_slots(
            params, torch.zeros(2, 4, dtype=torch.long), cache, [4, 2])
        assert logits.shape == (2, 4, cfg.vocab) and torch.isfinite(logits).all()
        assert cache["lengths"].tolist() == [4, 2]
        import repro_torch.core.grouped_approx  # noqa: F401
        for arch in ("olmo-1b-reduced", "rwkv6-1.6b-reduced",
                     "qwen3-4b-reduced", "deepseek-67b-reduced",
                     "deepseek-v2-lite-16b-reduced",
                     "moonshot-v1-16b-a3b-reduced", "hymba-1.5b-reduced"):
            cfg = get_config(arch)
            api = build_model(cfg, "cpu")
            params = build_serving_params(api.init(0), cfg, ServeConfig(
                policy=ApproxPolicy("perforated", 2, backend="pallas")),
                device="cpu")
            toks = torch.zeros(2, 5, dtype=torch.long)
            logits, cache = api.prefill(params, {"tokens": toks}, 8)
            logits, cache = api.decode_step(params, toks[:, :1], cache)
            assert logits.shape == (2, cfg.vocab) and cache["pos"] == 6
        assert cache["ssm_h"].dtype == torch.float32  # hymba's SSM state
        # the training step on the synthetic stream
        from repro_torch.data.synthetic import SyntheticLMConfig, lm_batch
        from repro_torch.launch.train import (TrainConfig, init_train_state,
                                              make_train_step)
        for arch in ("olmo-1b-reduced", "rwkv6-1.6b-reduced"):
            cfg = get_config(arch)
            tcfg = TrainConfig(grad_compress=True, microbatches=2)
            state = init_train_state(cfg, tcfg, device="cpu")
            step = make_train_step(cfg, tcfg, device="cpu")
            state, m = step(state, lm_batch(SyntheticLMConfig(
                vocab=cfg.vocab, seq_len=8, batch=2), 0))
            assert torch.isfinite(m["loss"]) and state["opt"]["step"] == 1
        from repro_torch.configs.cnn_suite import get_cnn
        from repro_torch.core.cost_model import power_saving
        from repro_torch.data.vision import VisionConfig, make_vision_dataset
        from repro_torch.nn.cnn import cnn_apply, init_cnn
        from repro_torch.numerics import apply_numerics, paper_grid_specs
        from repro_torch.quant.observers import CalibrationRecorder
        cfg = get_cnn("shufflenet")
        params = init_cnn(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
        x = torch.from_numpy(make_vision_dataset(VisionConfig(), "train", 2)[0])
        with CalibrationRecorder() as rec:
            cnn_apply(params, x, cfg)
        spec = paper_grid_specs(backend="pallas")[1]
        packed = apply_numerics(params, spec.resolve(params),
                                act_ranges=rec.ranges())
        assert cnn_apply(packed, x, cfg).shape == (2, 10)
        assert power_saving("perforated", 2, 64) > 0
        # folds, grouped CV, the paged layout, speculative decode, plan
        from repro_torch.configs import EngineConfig
        from repro_torch.launch.serve import run_plan
        from repro_torch.numerics import NumericsSpec, get_preset
        from repro_torch.serving import ServingEngine
        from repro_torch.serving.paged import PagedKVPool
        from repro_torch.serving.speculative import plan_round
        cfg = get_config("olmo-1b-reduced")
        api = build_model(cfg, "cpu")
        raw = api.init(0)
        verify = build_serving_params(raw, cfg, ServeConfig(
            spec=get_preset("int8")), device="cpu")
        draft = build_serving_params(raw, cfg, ServeConfig(
            policy=ApproxPolicy("perforated", 2, groups=4)), device="cpu")
        eng = ServingEngine(cfg, verify, EngineConfig(
            slots=2, max_len=32, prefill_chunk=8, kv_layout="paged",
            kv_block_size=4, speculative_k=2), api=api, draft_params=draft)
        assert isinstance(eng.pool, PagedKVPool)
        reqs = [eng.submit([1, 2, 3, 4, 5], 6), eng.submit([7, 8], 4)]
        assert len(eng.run()) == 2 and eng.compile_count() == 2
        assert eng.snapshot()["drafted_tokens"] > 0 and plan_round({}, 2, 8) is None
        # the robustness layer: probe, governor, faults, ladder, auto
        from repro_torch.numerics import auto, resolve_ladder
        from repro_torch.quant.faults import FaultInjector, FaultSpec
        from repro_torch.serving import GovernorConfig, NumericsGovernor
        approx = build_serving_params(raw, cfg, ServeConfig(
            policy=ApproxPolicy("perforated", 2)), device="cpu")
        gov = NumericsGovernor(
            resolve_ladder([get_preset("serve-default"), "int8", "float"], raw),
            GovernorConfig(slo_err_var=1e-3, window_probes=1))
        eng = ServingEngine(cfg, approx, EngineConfig(
            slots=2, max_len=32, prefill_chunk=8, error_probe_every=1),
            api=api, governor=gov, pack_fn=lambda s: raw if s is None else
            verify, exact_params=verify,
            fault_injector=FaultInjector(FaultSpec.parse("dense-noise@1@0-3")))
        eng.submit([1, 2, 3], 4)
        assert len(eng.run()) == 1 and eng.snapshot()["error_probe"]["runs"]
        assert gov.decisions and eng.snapshot()["power_attribution"]
        from repro_torch.core.approx_linear import dense
        toy = {"q": {"w": torch.randn(8, 8)}, "o": {"w": torch.randn(8, 8)}}
        x = torch.randn(4, 8)
        plan = NumericsSpec(name="a", default=auto(0.5)).resolve(
            toy, apply_fn=lambda p, b: dense(p["o"], dense(p["q"], b)),
            calib_inputs=x)
        assert all(e.policy is not None for e in plan.entries)
        class Args:
            arch, mode, m, no_cv, preset, spec_json = (
                "deepseek-67b", "perforated", 2, False, None, None)
            json, diff_checkpoint = True, None
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()):
            assert len(run_plan(Args()).entries) == 8
        # observability and the fleet: spans, windows, the merge, the
        # OpenMetrics text, a shadow replay, prefix sharing across replicas
        from repro_torch.serving import EngineMetrics, TierConfig, build_fleet
        from repro_torch.serving.prom import parse_openmetrics, to_openmetrics
        eng = ServingEngine(cfg, approx, EngineConfig(
            slots=2, max_len=32, prefill_chunk=8, trace=True,
            metrics_window_s=1e-4, shadow_fraction=1.0), api=api,
            shadow_params=verify, shadow_numerics="int8")
        eng.submit([1, 2, 3], 4)
        assert len(eng.run()) == 1
        assert eng.shadow_verdict()["sampled_requests"] == 1
        assert {e.kind for e in eng.tracer.events()} >= {
            "queued", "finished", "shadow", "metrics_window"}
        snap = EngineMetrics.merge([eng.snapshot(), eng.snapshot()])
        assert snap["engines"] == 2 and parse_openmetrics(to_openmetrics(snap))
        fleet = build_fleet(cfg, raw, [TierConfig("int8", "int8", count=2)],
                            EngineConfig(slots=2, max_len=32, prefill_chunk=8,
                                         kv_layout="paged", kv_block_size=4),
                            lambda n: (verify, n, get_preset(n)), api=api)
        fleet.replicas[0].engine.submit(list(range(12)), 2)
        fleet.drain()
        assert fleet.share_prefixes() == 3  # 12 prompt tokens, blocks of 4
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda():
    from repro_torch.configs import EngineConfig, get_config
    from repro_torch.launch.serve import ServeConfig, build_serving_params
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("olmo-1b-reduced")
    params = build_model(cfg, "cpu").init(0)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, EngineConfig(slots=2, max_len=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_serving_params(params, cfg, ServeConfig())
    from repro_torch.serving import TierConfig, build_fleet

    with pytest.raises(RuntimeError, match="CUDA"):
        build_fleet(cfg, params, [TierConfig("float", "float")],
                    EngineConfig(slots=2, max_len=16),
                    lambda name: (params, name, None))
    from repro_torch.configs.cnn_suite import get_cnn
    from repro_torch.nn.cnn import init_cnn

    with pytest.raises(RuntimeError, match="CUDA"):
        init_cnn(get_cnn("vgg13"), generator=torch.Generator())
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)

    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, TrainConfig())
