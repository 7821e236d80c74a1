"""PyTorch port vs JAX reference: fleet campaigns.

Both packages run a ``FleetCampaign`` over the same experiments on the numpy
sim engine: many ``JobExperiment``\\ s in lockstep rounds, one shared
``DecisionService`` deciding for all of them.  As in
``tests/test_torch_runner.py``, every port experiment gets its reference
twin's auto-encoder weights and initial parameters, and both sides' fits run
without metric dropout (the reference draws its masks from ``jax.random``).
The campaigns must agree pick for pick, with float32-equal runtimes, the
same service counters and, under the multi-tenant pool, the same capacity
trace.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core.service import DecisionService as JService
from repro.dataflow import FleetCampaign as JFleet
from repro.dataflow import JobExperiment as JExperiment
from repro_torch.convert import enel_params_from_numpy
from repro_torch.core.service import DecisionService
from repro_torch.dataflow import FleetCampaign, JobExperiment


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager ops are tiny, and test processes
    sharing a host's cores slow one another down with full pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _no_dropout(trainer):
    fit = trainer.fit_resident
    trainer.fit_resident = lambda **kw: fit(**dict(kw, metric_dropout=0.0))


def fleet_pair(job_keys, seed=7, stride=4, profile_runs=2):
    """(reference campaign, port campaign) over the same experiments, in the
    same state after ``profile(profile_runs)``."""
    jexps, exps = [], []
    for i, key in enumerate(job_keys):
        jex = JExperiment(key, seed=seed + i, candidate_stride=stride)
        ex = JobExperiment(key, seed=seed + i, candidate_stride=stride,
                           device="cpu", ae_params=_np(jex.encoder.ae_params))
        init = _np(jmodel.init_enel(jax.random.PRNGKey(seed + i)))
        ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
        ex.trainer.params = enel_params_from_numpy(init, device="cpu")
        _no_dropout(jex.trainer)
        _no_dropout(ex.trainer)
        jexps.append(jex)
        exps.append(ex)
    jc = JFleet(jexps, JService(seed=3))
    c = FleetCampaign(exps, DecisionService(seed=3))
    jc.profile(profile_runs)
    c.profile(profile_runs)
    return jc, c


def _run_key(st):
    return (tuple(st.scaleouts), np.float32(st.runtime),
            np.float32(st.violation), st.n_failures, st.n_rescales,
            st.decide_calls, st.fallback_decisions, st.shed_requests)


@pytest.fixture(scope="module")
def two_job_campaigns():
    """K-Means + GBT: one ``adaptive_round`` (service counters read after
    it), then one more run through ``adaptive_campaign`` with failures
    injected, on both sides."""
    jc, c = fleet_pair(("kmeans", "gbt"))
    out = {"round": (jc.adaptive_round("enel"), c.adaptive_round("enel"))}
    out["counters"] = [(s.batched_away, s.decisions, s.fallback_decisions)
                       for s in (jc.service, c.service)]
    out["campaign"] = (jc.adaptive_campaign(1, "enel", True)[0],
                       c.adaptive_campaign(1, "enel", True)[0])
    out["exps"] = (jc.experiments, c.experiments)
    return out


def test_adaptive_round_matches_jax(two_job_campaigns):
    jst, st = two_job_campaigns["round"]
    assert [_run_key(s) for s in st] == [_run_key(s) for s in jst]
    (jaway, jdec, jfb), (away, dec, fb) = two_job_campaigns["counters"]
    assert (away, dec, fb) == (jaway, jdec, jfb)
    assert dec == sum(s.decide_calls for s in st)
    assert away > 0                        # the two jobs' decisions batched


def test_fleet_campaign_matches_jax_pick_for_pick(two_job_campaigns):
    jstats, stats = two_job_campaigns["campaign"]
    assert [[_run_key(s) for s in run] for run in stats] == \
        [[_run_key(s) for s in run] for run in jstats]
    assert sum(s.n_failures for s in stats[0]) > 0
    assert len({p for s in stats[0] for p in s.scaleouts}) > 1
    jexps, exps = two_job_campaigns["exps"]
    for jex, ex in zip(jexps, exps):
        assert [s.kind for s in ex.stats] == [s.kind for s in jex.stats]
        assert ex.trainer.runs_seen == jex.trainer.runs_seen == 2
        assert ex.encoder.rng.rand() == jex.encoder.rng.rand()


def test_arrival_campaign_matches_jax():
    """Three experiments into a 40-executor pool with Poisson arrivals:
    the same per-job stats and the same capacity trace, row by row."""
    jc, c = fleet_pair(("kmeans", "gbt", "lr"), seed=21)
    kw = dict(pool_size=40, arrival_rate=1.2, seed=11, max_rounds=48)
    jstats, jtrace = jc.arrival_campaign(**kw)
    stats, trace = c.arrival_campaign(**kw)
    assert all(s is not None for s in stats)
    assert [_run_key(s) for s in stats] == [_run_key(s) for s in jstats]
    rows = lambda tr: [(t.round_idx, t.active, t.pool_used, t.pool_size,
                        t.capped_decisions, t.arrivals) for t in tr]
    assert rows(trace) == rows(jtrace)
    assert all(t.pool_used <= 40 for t in trace)
    assert all(ex.scale_cap is None for ex in c.experiments)
    assert c.service.decisions == jc.service.decisions
