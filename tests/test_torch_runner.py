"""PyTorch port vs JAX reference: Enel's online loop for one job.

Both packages run ``JobExperiment`` on the seeded K-Means job: profiling
runs, the scratch fit on the resident ring, then adaptive runs with the
cadence fit after each.  The port gets the reference's auto-encoder weights
and its initial parameters (for the first and for every scratch init), and
both fits run without metric dropout (the reference draws its masks from
``jax.random``, which the port cannot reproduce), set on each trainer by a
monkeypatch.  Both answer decisions through their ``DecisionService``;
the picks must agree at every boundary, and under the same ``ChaosSpec``
so must the fallback, retry and breaker counts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.dataflow import runner as jrunner
from repro_torch.convert import enel_params_from_numpy
from repro_torch.dataflow import runner
from repro_torch.sim.chaos import ChaosInjector, ChaosSpec

RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these eager ops are tiny, and test processes
    that share a host's cores while each spins a full thread pool slow one
    another down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _record_fits(monkeypatch, trainer, losses):
    """Force ``metric_dropout=0`` on a trainer's resident fits and keep
    the losses they return."""
    fit = trainer.fit_resident

    def no_dropout(**kw):
        loss = fit(**dict(kw, metric_dropout=0.0))
        losses.append(loss)
        return loss
    monkeypatch.setattr(trainer, "fit_resident", no_dropout)


@pytest.fixture(scope="module")
def pair():
    """(reference experiment, port experiment) on K-Means, seed 0, in the
    same state and with the same weights."""
    jex = jrunner.JobExperiment("kmeans", seed=0)
    ex = runner.JobExperiment("kmeans", seed=0, device="cpu",
                              ae_params=_np(jex.encoder.ae_params))
    init = _np(jmodel.init_enel(jax.random.PRNGKey(0)))
    ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
    ex.trainer.params = enel_params_from_numpy(init, device="cpu")
    return jex, ex


def test_job_experiment_matches_jax(pair, monkeypatch):
    jex, ex = pair
    jlosses, losses = [], []
    _record_fits(monkeypatch, jex.trainer, jlosses)
    _record_fits(monkeypatch, ex.trainer, losses)
    jex.profile(n_runs=3)
    ex.profile(n_runs=3)
    np.testing.assert_allclose(ex.target, jex.target, rtol=RTOL)
    for _ in range(2):
        jst = jex.adaptive_run("enel", inject_failures=False)
        st = ex.adaptive_run("enel", inject_failures=False)
        assert st.scaleouts == jst.scaleouts
        assert st.decide_calls == jst.decide_calls
        np.testing.assert_allclose(st.runtime, jst.runtime, rtol=RTOL)
        np.testing.assert_allclose(st.violation, jst.violation, rtol=RTOL,
                                   atol=1e-6)
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert all(np.isfinite(losses))
    assert len({s for st in ex.stats for s in st.scaleouts}) > 1
    # the Ellis baseline and the shared history stay in step too
    jst = jex.adaptive_run("ellis", inject_failures=True)
    st = ex.adaptive_run("ellis", inject_failures=True)
    assert st.scaleouts == jst.scaleouts and st.n_failures == jst.n_failures
    np.testing.assert_allclose(st.runtime, jst.runtime, rtol=RTOL)
    assert ex.trainer.cache.count == jex.trainer.cache.count
    assert [s.kind for s in ex.stats] == [s.kind for s in jex.stats]
    assert ex.encoder.rng.rand() == jex.encoder.rng.rand()


def test_chaos_run_quarantines_and_recovers():
    """Poisoned graphs are quarantined on entry, a corrupted ring row is
    healed by the retry, NaN params fall back until the scratch retrain."""
    ex = runner.JobExperiment("kmeans", seed=0, device="cpu")
    ex.chaos = ChaosInjector(ChaosSpec(name="t", nan_graphs_every=2,
                                       cache_corrupt_every=3,
                                       nan_fit_every=4), exp_seed=0)
    ex.profile(n_runs=2)
    finite_after = []
    for _ in range(6):
        ex.adaptive_run("enel", inject_failures=False)
        finite_after.append(ex.trainer.params_finite())
    c = ex.chaos
    assert c.graphs_poisoned > 0 and c.cache_rows_corrupted > 0
    assert c.fits_poisoned > 0
    assert ex.trainer.cache.quarantined >= c.graphs_poisoned
    # decisions go through the service: its guardrail answers them
    assert ex.service.fallback_decisions > 0
    assert ex.service.guardrail_trips == ex.service.fallback_decisions
    assert sum(st.fallback_decisions for st in ex.stats) == \
        ex.service.fallback_decisions
    # run 4 poisons the params after its fit; run 5's scratch retrain heals
    assert finite_after[3] is False and finite_after[4] is True
    lo, hi = 4, 36
    assert all(lo <= s <= hi for st in ex.stats for s in st.scaleouts)


def test_chaos_counts_match_jax(monkeypatch):
    """Under one ``ChaosSpec`` (NaN params after a fit, bursts of dispatch
    timeouts longer than the retry budget) the port's and the reference's
    experiments pick alike and count the same guardrail fallbacks, retries,
    exhausted dispatches and breaker trips, run by run."""
    from repro.core.service import DecisionService as JService
    from repro.sim.chaos import ChaosInjector as JInjector
    from repro.sim.chaos import ChaosSpec as JSpec
    from repro.sim.chaos import make_dispatch_chaos as jmake_dispatch_chaos
    from repro_torch.core.service import DecisionService
    from repro_torch.sim.chaos import make_dispatch_chaos
    plan = dict(name="t", nan_fit_every=4, timeout_every=6, timeout_burst=9)
    fast = dict(backoff_base_s=1e-4, backoff_cap_s=1e-3)
    jex = jrunner.JobExperiment("kmeans", seed=0,
                                service=JService(**fast))
    ex = runner.JobExperiment("kmeans", seed=0, device="cpu",
                              service=DecisionService(**fast),
                              ae_params=_np(jex.encoder.ae_params))
    init = _np(jmodel.init_enel(jax.random.PRNGKey(0)))
    ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
    ex.trainer.params = enel_params_from_numpy(init, device="cpu")
    jex.service.fault_injector = jmake_dispatch_chaos(JSpec(**plan))
    ex.service.fault_injector = make_dispatch_chaos(ChaosSpec(**plan))
    jex.chaos = JInjector(JSpec(**plan), exp_seed=0)
    ex.chaos = ChaosInjector(ChaosSpec(**plan), exp_seed=0)
    _record_fits(monkeypatch, jex.trainer, [])
    _record_fits(monkeypatch, ex.trainer, [])
    jex.profile(n_runs=2)
    ex.profile(n_runs=2)
    for _ in range(6):
        jst = jex.adaptive_run("enel", inject_failures=False)
        st = ex.adaptive_run("enel", inject_failures=False)
        assert st.scaleouts == jst.scaleouts
        assert (st.fallback_decisions, st.retries, st.breaker_trips) == \
            (jst.fallback_decisions, jst.retries, jst.breaker_trips)
    got, want = ex.service.stats(), jex.service.stats()
    assert got == want
    assert got["guardrail_trips"] > 0 and got["retries"] > 0
    assert got["breaker_trips"] > 0 and got["dispatch_failures"] > 0
    assert got["fallback_decisions"] > got["guardrail_trips"]


def test_execute_run_matches_the_service_run():
    """One run generator behind both drivers: a run decided through the
    experiment's ``DecisionService`` (sparse engine) and the same run on a
    twin experiment decided by ``execute_run`` (``recommend``, dense
    route) give the same picks, runtime and graphs, and totals within
    1e-5 relative."""
    a, b = (runner.JobExperiment("kmeans", seed=0, device="cpu")
            for _ in range(2))
    for ex in (a, b):
        ex.calibrate_target(n_runs=3)
        ex.trainer.fit_resident(steps=160, from_scratch=True)
    assert a.target == b.target
    s0 = 20
    got = a._execute(method="enel", inject_failures=True, initial_s=s0)
    want = runner.execute_run(
        sim=b.sim, encoder=b.encoder, job=b.job, scaler=b.enel,
        initial_s=s0, inject_failures=True, target=b.target,
        decision_interval=b.decision_interval, ellis=b.ellis)
    assert a.service.decisions == len(got.decisions) == len(want.decisions)
    assert [d.pick for d in got.decisions] == \
        [d.pick for d in want.decisions]
    assert len({d.pick for d in got.decisions}) > 1      # the picks move
    assert got.scaleouts == want.scaleouts
    assert got.run.runtime == want.run.runtime
    assert len(got.graphs) == len(want.graphs) == b.job.n_components
    for dg, dw in zip(got.decisions, want.decisions):
        assert not dg.fallback and not dg.shed
        assert dg.totals.keys() == dw.totals.keys()
        np.testing.assert_allclose([dg.totals[s] for s in dw.totals],
                                   list(dw.totals.values()), rtol=1e-5)
