"""The port's numpy copies of the paper path's host modules against the
JAX package's: the procedural vision dataset (byte-equal images and
labels), the MAC-array cost model (equal numbers: the same float64
arithmetic in the same order) and the Tables 2-4 spec grid."""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import cost_model as jcm
from repro.data import vision as jvision
from repro.numerics import paper_grid_specs as jax_grid
from repro_torch.core import cost_model as tcm
from repro_torch.core.multipliers import APPROX_MODES, PAPER_M_RANGE
from repro_torch.data import vision as tvision
from repro_torch.numerics import NumericsSpec, paper_grid_specs

GRID = [(mode, m) for mode in APPROX_MODES for m in PAPER_M_RANGE[mode]]


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("classes", [10, 100])
def test_vision_dataset_byte_equal(classes, split):
    jx, jy = jvision.make_vision_dataset(
        jvision.VisionConfig(num_classes=classes), split, 48)
    tx, ty = tvision.make_vision_dataset(
        tvision.VisionConfig(num_classes=classes), split, 48)
    assert tx.dtype == jx.dtype and tx.shape == jx.shape == (48, 32, 32, 3)
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()
    assert len(set(ty.tolist())) > 1


@pytest.mark.parametrize("n_array", [8, 64, 256])
def test_cost_model_equal_over_the_grid(n_array):
    assert dataclasses.asdict(tcm.power_units()) == dataclasses.asdict(
        jcm.power_units())
    assert dataclasses.asdict(tcm.area_units()) == dataclasses.asdict(
        jcm.area_units())
    assert tcm.PAPER_POWER_SAVINGS == jcm.PAPER_POWER_SAVINGS
    assert tcm.PAPER_AREA_SAVINGS == jcm.PAPER_AREA_SAVINGS
    for mode, m in GRID + [("exact", 0)]:
        assert tcm.power_saving(mode, m, n_array) == jcm.power_saving(
            mode, m, n_array), (mode, m)
        assert tcm.area_saving(mode, m, n_array) == jcm.area_saving(
            mode, m, n_array), (mode, m)
        for units in (tcm.power_units(), tcm.area_units()):
            ju = jcm.UnitCosts(**dataclasses.asdict(units))
            for cv in (True, False):
                assert tcm.normalized_cost(mode, m, n_array, units, cv) == \
                    jcm.normalized_cost(mode, m, n_array, ju, cv), (mode, m)
                assert tcm.array_cost(mode, m, n_array, units, cv) == \
                    jcm.array_cost(mode, m, n_array, ju, cv), (mode, m)
    # the model saves power on every approximate point of the grid
    assert all(tcm.power_saving(mode, m, n_array) > 0 for mode, m in GRID)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("use_cv", [True, False], ids=["cv", "no-cv"])
def test_paper_grid_specs_equal_and_round_trip(use_cv, backend):
    tspecs = paper_grid_specs(use_cv=use_cv, backend=backend)
    jspecs = jax_grid(use_cv=use_cv, backend=backend)
    assert [s.name for s in tspecs] == [s.name for s in jspecs]
    assert [(s.default.mode, s.default.m) for s in tspecs] == GRID
    for ts, js in zip(tspecs, jspecs):
        assert ts.default.use_cv is use_cv and ts.default.backend == backend
        assert json.loads(ts.to_json()) == json.loads(js.to_json())
        assert NumericsSpec.from_json(js.to_json()) == ts
        assert NumericsSpec.from_json(ts.to_json()) == ts
