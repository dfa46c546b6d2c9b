"""``auto(...)`` rules and the ``paper-grid`` preset in the port, held
against the reference package: the analytic error moments and the
most-aggressive-first order for every (mode, m); the greedy search's
per-layer policies on the reference's toy tree and on a reduced CNN
(width 8, depth 1, 16x16, weights carried across by the bridge, the
reference's calibration ranges), equal policy for policy; the error
without calibration inputs; the JSON round trip of an ``auto`` action;
the preset's name and rules; ``is_exact``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.multipliers as jax_mult
import repro.core.policy as jax_policy
import repro.numerics as jn
import repro_torch.core.multipliers as port_mult
import repro_torch.core.policy as port_policy
import repro_torch.numerics as tn
from repro.checkpoint.manager import _flatten
from repro.core.approx_linear import dense as jax_dense
from repro.nn import cnn as jcnn
from repro.quant import observers as jobs
from repro_torch.bridge import from_jax_cnn_params
from repro_torch.core.approx_linear import dense
from repro_torch.nn import cnn as tcnn

MODES = [("exact", 0)] + [(mode, m) for mode in ("perforated", "recursive",
                                                  "truncated")
                          for m in range(0, 9)]


@pytest.mark.parametrize("mode,m", MODES, ids=[f"{a}-{b}" for a, b in MODES])
def test_analytic_error_moments_match_reference(mode, m):
    assert port_mult.analytic_error_moments_uniform(mode, m) == \
        jax_mult.analytic_error_moments_uniform(mode, m)


@pytest.mark.parametrize("use_cv", [True, False])
def test_order_most_aggressive_matches_reference(use_cv):
    port = port_policy.order_most_aggressive(
        port_policy.paper_policies(use_cv=use_cv))
    ref = jax_policy.order_most_aggressive(
        jax_policy.paper_policies(use_cv=use_cv))
    assert [p.to_dict() for p in port] == [p.to_dict() for p in ref]
    assert len(port) == 9


def _toy_params():
    """The reference's toy tree (``tests/test_numerics_spec.py``), and the
    same values as a port tree."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jp = {
        "embed": {"table": jnp.zeros((32, 8))},
        "blocks": {
            "attn": {"q": {"w": jax.random.normal(k1, (8, 8)) * 0.3},
                     "router": {"w": jnp.zeros((8, 4))}},
            "denormalizer": {"w": jax.random.normal(k2, (8, 8)) * 0.3},
            "attn_norm": {"scale": jnp.ones(8)},
        },
        "lm_head": {"w": jax.random.normal(k3, (8, 32)) * 0.3,
                    "b": jnp.zeros(32)},
    }
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _toy_apply_jax(p, x):
    h = jax_dense(p["blocks"]["attn"]["q"], x)
    h = jax_dense(p["blocks"]["denormalizer"], jax.nn.gelu(h))
    return jax_dense(p["lm_head"], h)


def _toy_apply_port(p, x):
    h = dense(p["blocks"]["attn"]["q"], x)
    h = dense(p["blocks"]["denormalizer"],
              torch.nn.functional.gelu(h, approximate="tanh"))
    return dense(p["lm_head"], h)


def _entries(plan):
    """The plan's rows by path (the reference's pytree walk visits dict
    keys sorted, the port's in insertion order)."""
    return sorted((e.path, None if e.policy is None else e.policy.to_dict(),
                   e.rule, e.power_saving_pct) for e in plan.entries)


@pytest.mark.parametrize("budget", [0.02, 0.15, 0.6])
def test_auto_lowers_like_the_reference_on_the_toy_tree(budget):
    jp, tp = _toy_params()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (16, 8)))

    def spec(mod):
        return mod.NumericsSpec(
            name="auto-test",
            rules=(mod.Rule("router", mod.FLOAT), mod.Rule("embed*",
                                                           mod.FLOAT)),
            default=mod.auto(budget=budget))

    ref = spec(jn).resolve(jp, apply_fn=_toy_apply_jax,
                           calib_inputs=jnp.asarray(x))
    port = spec(tn).resolve(tp, apply_fn=_toy_apply_port,
                            calib_inputs=torch.from_numpy(x))
    assert _entries(port) == _entries(ref)
    lowered = [e for e in port.entries if "auto" in e.rule]
    assert lowered and all(e.policy is not None for e in lowered)


def test_auto_policy_matches_reference_on_the_toy_tree():
    jp, tp = _toy_params()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (16, 8)))
    _, jrows = jax_policy.auto_policy(_toy_apply_jax, jp, jnp.asarray(x),
                                      budget_rel_err=0.1, skip=("embed",))
    _, trows = port_policy.auto_policy(_toy_apply_port, tp,
                                       torch.from_numpy(x),
                                       budget_rel_err=0.1, skip=("embed",))
    assert trows == jrows and trows


def test_paper_grid_lowers_like_the_reference_on_a_reduced_cnn():
    kw = dict(family="resnet", width=8, depth=1, img_size=16)
    jc, tc = jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), jc)
    tp = from_jax_cnn_params(dict(_flatten(jp)[0]))
    x = np.random.default_rng(0).random((4, 16, 16, 3)).astype(np.float32)
    with jobs.CalibrationRecorder() as rec:
        jcnn.cnn_apply(jp, jnp.asarray(x), jc)
    ranges = rec.ranges()
    ref = jn.get_preset("paper-grid").resolve(
        jp, apply_fn=lambda p, b: jcnn.cnn_apply(p, b, jc),
        calib_inputs=jnp.asarray(x), act_ranges=ranges)
    port = tn.get_preset("paper-grid").resolve(
        tp, apply_fn=lambda p, b: tcnn.cnn_apply(p, b, tc),
        calib_inputs=torch.from_numpy(x), act_ranges=ranges)
    assert _entries(port) == _entries(ref)
    assert port.spec_name == "paper-grid[auto<=0.05]"
    chosen = {e.policy.label() for e in port.entries if e.policy is not None}
    assert chosen - {"int8-exact"}  # the search kept an approximate layer
    packed = tn.apply_numerics(tp, port, act_ranges=ranges)
    assert tcnn.cnn_apply(packed, torch.from_numpy(x), tc).shape == (4, 10)


def test_auto_without_calibration_inputs_raises_the_reference_error():
    jp, tp = _toy_params()
    errs = []
    for mod, params in ((jn, jp), (tn, tp)):
        with pytest.raises(ValueError) as e:
            mod.NumericsSpec(name="a", default=mod.auto(budget=0.1)).resolve(
                params)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "auto" in errs[0]


def test_auto_json_round_trip_matches_reference():
    def spec(mod):
        return mod.NumericsSpec(
            name="mixed",
            rules=(mod.Rule("lm_head", mod.FLOAT),
                   mod.Rule(r"attn/(q|v)$", mod.auto(budget=0.1),
                            kind="regex"),
                   mod.Rule("o", mod.auto(0.2, candidates="paper-grid-nocv"))),
            default=mod.auto())

    text = spec(tn).to_json()
    assert text == spec(jn).to_json()
    back = tn.NumericsSpec.from_json(text)
    assert back == spec(tn)
    assert back.rules[1].action == tn.Auto(budget_rel_err=0.1)
    assert jn.NumericsSpec.from_json(text).to_json() == text
    for kw in ({"candidates": "nope"}, {"budget": 0.0}):
        errs = []
        for mod in (jn, tn):
            with pytest.raises(ValueError) as e:
                mod.auto(**kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("budget", [None, 0.1])
def test_paper_grid_preset_matches_reference(budget):
    kw = {} if budget is None else {"budget": budget}
    port, ref = tn.get_preset("paper-grid", **kw), jn.get_preset(
        "paper-grid", **kw)
    assert port.to_json() == ref.to_json()
    assert port.name == f"paper-grid[auto<={budget or 0.05}]"
    assert port.rules == tn.SERVE_FLOAT_RULES
    assert not port.is_exact and "paper-grid" in tn.PRESETS


def test_is_exact_matches_reference():
    for name in ("serve-default", "int8", "paper-grid"):
        assert tn.get_preset(name).is_exact == jn.get_preset(name).is_exact
    assert tn.get_preset("int8").is_exact
    assert tn.NumericsSpec(name="f", default=tn.FLOAT).is_exact
