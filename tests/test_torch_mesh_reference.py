"""The port's files-mesh ``FeatureDatabase`` against the benchmark's plain
float64 reference (``portbench/reference/serve.py``), on the CPU.

The ``serve107k`` deployment at its tiny size: 42 seeded files over a mesh
of four ``cpu`` shards, with the complex64 spectra cache and the in-memory
raw store, staged and queried by the benchmark's own serving traffic
(``portbench/traffic/database.py``).  42 is no multiple of four, so the
last shard ends in 2 padding rows, as the real one does.  That module's
``check`` holds every request, over every file, to the reference: its own
cut is its best hit, the served sims match the reference's at the served
windows (a punch on the scale of in · out), the reference's top-k lies no
higher than what was served, and the boosts match; all at the limits of
``portbench/workloads/punch.json``.  No padding row scores anywhere.
Imports no JAX.
"""

import json
import os

import numpy as np
import pytest

from portbench import harness
from portbench.traffic import database as serving

FILES, SHARDS = 42, 4
BASE = harness.BASE


def _part(*path):
    """A configuration or mix with its ``tiny`` group in place."""
    with open(os.path.join(BASE, *path)) as f:
        part = json.load(f)
    part.update(part.pop("tiny"))
    return part


CONFIG = _part("configs", "serve107k.json")
LIMITS = _part("workloads", "punch.json")["limits"]


def _serve(seed, traffic):
    """``(state, ctx, outputs, gathered)``: the traffic's set-up over a
    four-shard mesh, one request a sampled unit, and each request's raw
    gather with its padding rows (``FeatureDatabase._gather`` spied)."""
    mix = _part("workloads", f"{traffic}.json")
    ctx = harness.Ctx(f"serve107k.{traffic}", CONFIG, mix, seed, 0.0, False,
                      "cpu", chips=SHARDS, devices=("cpu",) * SHARDS)
    state = serving.setup(ctx)
    gathered = []
    real = state.db._gather

    def spy(parts):
        out = real(parts)
        gathered.append(out)
        return out
    state.db._gather = spy
    outputs = [serving.unit(state, i) for i in range(mix["sample"])]
    return state, ctx, outputs, gathered


@pytest.fixture(scope="module", params=[11, 2**31 + 5, 2**33 + 7])
def punched(request):
    return _serve(request.param, "punch")


@pytest.fixture(scope="module", params=[11, 2**31 + 5, 2**33 + 7])
def queried(request):
    return _serve(request.param, "query")


def _no_padding_scores(outputs, gathered):
    """The results have the library's rows alone, and every padding row of
    the last shard was gathered as −inf."""
    assert len(gathered) == len(outputs)
    for res, parts in zip(outputs, gathered):
        assert res.sims.shape == (FILES, 4) and len(res.files) == FILES
        vals = parts[0]
        assert vals.shape[0] == FILES + (-FILES % SHARDS)
        assert np.isneginf(vals[FILES:]).all()


def _holds_the_reference(state, ctx, outputs):
    checks = serving.check(state, outputs, ctx)
    assert [name for name, _, _ in checks] == list(LIMITS)
    for name, value, _ in checks:
        assert value <= LIMITS[name], (name, value)


def test_the_mesh_pads_the_last_shard(punched):
    db = punched[0].db
    rows = [sh.rows for sh in db._shards]
    assert [r.stop - r.start for r in rows] == [11] * 4
    assert db._lens[FILES:].tolist() == [0, 0]


def test_query_punch_holds_the_reference(punched):
    state, ctx, outputs, gathered = punched
    _no_padding_scores(outputs, gathered)
    _holds_the_reference(state, ctx, outputs)


def test_query_holds_the_reference(queried):
    state, ctx, outputs, gathered = queried
    _no_padding_scores(outputs, gathered)
    _holds_the_reference(state, ctx, outputs)
