"""The control on the card: the reference itself computed with TF32 on,
the precision below the configurations' float32 with TF32 off, in the
program's place, comes out not correct in both cells, as do the planted
faults that set an upper reading: eval's Sinkhorn a round short and a view
turned, training's half batch (a state left unchanged reads 1 by the
training readings' measure and needs no run). At the cells' own sizes, on
one seed; `tools/readings.py` reads more seeds for the limits."""

import json
from pathlib import Path

import pytest

from benchmark.harness import registry, session

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]


def _over(cell, readings):
    limits = cell.workload["check"]["limits"]
    return [k for k in limits if k in readings and not readings[k] <= limits[k]]


@pytest.mark.parametrize("name, fault", [
    ("megadepth5-eval", None), ("megadepth5-eval", "sinkhorn_round_fewer"),
    ("megadepth5-eval", "view_turned"), ("scannet5-train", None),
    ("scannet5-train", "half_batch")])
def test_control_is_not_correct(card, name, fault):
    cell = registry.cell(ROOT, name)
    entry = registry.entry(cell.workload["entry"])
    run = session.Run(cell, 3_000_000_019, 1.0, 0, card, 0.0)
    if cell.workload["entry"] == "eval_multi_view":
        readings = entry.control(run, [0], fault)
    else:
        readings = entry.control(run, fault)
    assert _over(cell, readings), json.dumps(readings)
