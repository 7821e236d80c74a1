"""PyTorch port vs JAX reference: the scenario, chaos and transfer harness
(``sim/evaluate.py``) on the vectorized engine.

Both packages' harness functions run at a small size (2 jobs,
``profile_runs=2``, one or two adaptive runs, ``candidate_stride=4``) on
their batched engines.  As in ``tests/test_torch_fleet.py`` every port
experiment gets its reference twin's auto-encoder weights and initial
parameters, and both sides' fits run without metric dropout (the reference
draws its masks from ``jax.random``): the harness modules' ``JobExperiment``
is wrapped to do so.  Runs stay below the 5th, so no K-Means scratch
retrain after the profile's fit (the step-79 split closed in
``tests/test_torch_training.py``) enters a trace.  The rows must be equal
on every column but those named in ``EXCLUDED``.

Both packages' ``obs`` singletons are left as they were found (the chaos
campaign writes registry series and recorder spans), so no reference test
later in the same process reads this file's state.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import model as jmodel
from repro.dataflow import JobExperiment as JExperiment
from repro.sim import evaluate as jevaluate
from repro_torch import obs
from repro_torch.convert import enel_params_from_numpy
from repro_torch.dataflow import JobExperiment
from repro_torch.sim import evaluate

SMALL = dict(seed=0, profile_runs=2, candidate_stride=4)
TWO_JOBS = ("kmeans", "gbt")

# columns left out of the equality, with the reason
EXCLUDED = {
    "wall_s_adaptive": "host wall time",
    "decisions_per_s": "host wall time",
    "controller_health": "every enel_ series of the process's registry: "
                         "depends on what ran before in the process",
}
# the reused model's prediction error is a float of the model's output,
# held at the runner tests' tolerance for predictions
PRED_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager ops are tiny, and test processes
    sharing a host's cores slow one another down with full pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_left_as_found():
    """Both packages' obs registries, recorders and gates as on entry:
    series made by the test are dropped and the others restored."""
    mods = (obs, jobs)
    saved = [(m, m.registry().snapshot(), m.recorder().state(), m.enabled())
             for m in mods]
    yield
    for m, snap, rec, on in saved:
        reg = m.registry()
        for name in reg.names():
            kept = snap.get(name, {}).get("series", {})
            metric = reg.get(name)
            for key in list(metric.series()):
                if json.dumps(key) not in kept:
                    metric.drop(**dict(key))
        reg.restore(snap)
        m.recorder().load(rec)
        m.set_enabled(on)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _no_dropout(trainer):
    fit = trainer.fit_resident
    trainer.fit_resident = lambda **kw: fit(**dict(kw, metric_dropout=0.0))


def _port_twin(jex, key, *args, **kw):
    """The port's experiment for the reference's ``jex``: its auto-encoder
    weights and initial parameters, no dropout (a shared model is the
    source's, already set up)."""
    assert (jex.job_key, jex.seed) == (key, kw["seed"])
    if kw.get("share_models_from") is not None:
        return JobExperiment(key, *args, device="cpu",
                             **{k: v for k, v in kw.items() if k != "device"})
    kw = dict(kw, device="cpu", ae_params=_np(jex.encoder.ae_params))
    ex = JobExperiment(key, *args, **kw)
    init = _np(jmodel.init_enel(jax.random.PRNGKey(kw["seed"])))
    ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
    ex.trainer.params = enel_params_from_numpy(init, device="cpu")
    _no_dropout(ex.trainer)
    return ex


@pytest.fixture
def twins(monkeypatch):
    """Run ``fn(module, **kw)`` on the reference's harness, then on the
    port's with the twins of the reference's experiments, in order."""
    made = []

    def jmake(key, *args, **kw):
        ex = JExperiment(key, *args, **kw)
        if kw.get("share_models_from") is None:
            _no_dropout(ex.trainer)
        made.append(ex)
        return ex

    def run(fn, *args, **kw):
        monkeypatch.setattr(jevaluate, "JobExperiment", jmake)
        want = fn(jevaluate, *args, **kw)
        twins = iter(made)
        monkeypatch.setattr(
            evaluate, "JobExperiment",
            lambda key, *a, **k: _port_twin(next(twins), key, *a, **k))
        got = fn(evaluate, *args, device="cpu", **kw)
        assert next(twins, None) is None
        return got, want
    return run


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in EXCLUDED:
                continue
            if k == "pred_rel_err_mean":
                np.testing.assert_allclose(g[k], w[k], rtol=PRED_RTOL)
            else:
                assert g[k] == w[k], (g["job"], k, g[k], w[k])


@pytest.mark.parametrize("scenario", ["node_failure", "multi_tenant"])
def test_scenario_campaign_matches_jax(twins, scenario):
    got, want = twins(lambda m, **kw: m.run_scenario_campaign(
        scenario, TWO_JOBS, adaptive_runs=1, **SMALL, **kw))
    _assert_rows_equal(got, want)
    assert [r["job"] for r in got] == [*TWO_JOBS, "__fleet__"]
    assert all(r["engine"] == "batched" for r in got)
    assert got[-1]["decisions"] > 0
    if scenario == "multi_tenant":
        assert got[-1]["pool_size"] == 96 and got[-1]["rounds"] > 0
    else:
        assert sum(r["failures_total"] for r in got[:-1]) > 0


def test_chaos_campaign_matches_jax(twins):
    """``chaos_crashes``: two controller crashes recovered from the shared
    backend's checkpoints, on both sides."""
    got, want = twins(lambda m, **kw: m.run_chaos_campaign(
        "chaos_crashes", TWO_JOBS, adaptive_runs=2, **SMALL, **kw))
    _assert_rows_equal(got, want)
    fleet = got[-1]
    assert fleet["restores"] == 2
    assert fleet["svc_decisions"] == sum(r["decisions"] for r in got[:-1])


def test_transfer_cell_matches_jax(twins):
    got, want = twins(lambda m, **kw: m.run_transfer_cell(
        "baseline", 1.0, "node_failure", 1.6, "kmeans", train_runs=1,
        calibrate_runs=2, adaptive_runs=2, **SMALL, **kw))
    _assert_rows_equal([got], [want])
    assert got["runs"] == 2 and "pred_rel_err_mean" in got


def test_chaos_trace_identity_holds():
    """A ``chaos_model`` campaign on the shared batched engine, killed at
    rounds 2 and 5 and restored from checkpoints, gives the uninterrupted
    trace."""
    assert evaluate.chaos_trace_identity(adaptive_runs=2, device="cpu")
