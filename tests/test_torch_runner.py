"""PyTorch port vs JAX reference: Enel's online loop for one job.

Both packages run ``JobExperiment`` on the seeded K-Means job: profiling
runs, the scratch fit on the resident ring, then adaptive runs with the
cadence fit after each.  The port gets the reference's auto-encoder weights
and its initial parameters (for the first and for every scratch init), and
both fits run without metric dropout (the reference draws its masks from
``jax.random``, which the port cannot reproduce), set on each trainer by a
monkeypatch.  The reference answers decisions through its
``DecisionService``, the port calls ``recommend`` directly; the picks must
agree at every boundary.
"""
import jax
import numpy as np
import pytest

from repro.core import model as jmodel
from repro.dataflow import runner as jrunner
from repro_torch.convert import enel_params_from_numpy
from repro_torch.dataflow import runner
from repro_torch.sim.chaos import ChaosInjector, ChaosSpec

RTOL = 1e-3


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
    assert ex.enel.fallback_decisions > 0
    assert sum(st.fallback_decisions for st in ex.stats) == \
        ex.enel.fallback_decisions
    # run 4 poisons the params after its fit; run 5's scratch retrain heals
    assert finite_after[3] is False and finite_after[4] is True
    lo, hi = 4, 36
    assert all(lo <= s <= hi for st in ex.stats for s in st.scaleouts)
