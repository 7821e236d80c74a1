"""PyTorch port vs JAX reference: the fused whole-campaign driver and its
guardrail ``fallback_pick``.

Both packages build the fixture fleet of ``tests/test_fused_campaign.py``
(kmeans, gbt and kmeans with seeds 7, 8 and 7; node_failure, baseline and
node_failure; ``nan_fit`` chaos on slot 0 after ``profile(3)``) on their
batched engines.  As in ``tests/test_torch_fleet.py`` every port experiment
gets its reference twin's auto-encoder weights and initial parameters, and
both sides' fits run without metric dropout (the reference draws its masks
from ``jax.random``): the profiles' fits, and the plans, built with
``metric_dropout=0``.  Then:

* every plan table is equal, but the learned state; the frozen context
  tables hold the encoder's contexts, equal to 1e-6 as
  ``tests/test_torch_host.py`` holds them;
* the campaign's outputs are equal: the sim, the decisions and the
  guardrail bit for bit, the fits' losses and the final parameters within
  atol 1e-4, rtol 1e-3 (the training tests' gradient tolerance), and
  ``materialize_fused``'s stats;
* ``fallback_pick`` equals the reference's on drawn inputs (NaN and +-inf
  totals, ties, invalid candidates, non-finite elapsed times and targets)
  and, where the host's float64 urgency falls on the same side of both
  thresholds as the float32 one, ``FallbackPolicy.decide``.

Both packages' ``obs`` singletons are left as they were found.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, example, given, settings
from hypothesis import strategies as st

import repro.core.campaign_kernel as jck
from repro import obs as jobs
from repro.core import model as jmodel
from repro.core.fallback import fallback_pick as jfallback_pick
from repro.core.service import DecisionService as JService
from repro.dataflow import FleetCampaign as JFleet
from repro.dataflow import JobExperiment as JExperiment
from repro.dataflow.fleet import materialize_fused as jmaterialize
from repro.sim.chaos import ChaosInjector as JChaos
from repro.sim.chaos import ChaosSpec as JSpec
from repro.sim.scenarios import make_scenario as jmake_scenario
from repro_torch import obs
from repro_torch.convert import enel_params_from_numpy
from repro_torch.core import campaign_kernel as ck
from repro_torch.core.fallback import FallbackPolicy, fallback_pick
from repro_torch.core.service import DecisionService
from repro_torch.core.training import param_leaves
from repro_torch.dataflow import FleetCampaign, JobExperiment
from repro_torch.dataflow.fleet import materialize_fused
from repro_torch.sim.chaos import ChaosInjector, ChaosSpec
from repro_torch.sim.scenarios import make_scenario

N_RUNS = 3
PROFILE_RUNS = 3
JOBS = (("kmeans", 7, "node_failure"), ("gbt", 8, "baseline"),
        ("kmeans", 7, "node_failure"))
SCRATCH_RUN = 2                 # retrain_every=2 after profiling: run 2
CTX_ATOL = 1e-6                 # the encoder's contexts, tests/test_torch_host
FIT_TOL = dict(atol=1e-4, rtol=1e-3)
CONTEXT_TABLES = ("obs_ctx", "p_ctx", "hob_ctx", "hsw_ctx")
# the reference's device tables the port keeps elsewhere or does without:
# the dropout key, the lr and dropout rate (host values here), the
# branches' tables (host copies), the initial parameters (learned state)
NOT_DEVICE = ("base_key", "lr", "dropout_p", "any_decide", "scratch_at",
              "poison_at", "init_params")
EXACT_YS = ("a", "z", "s_next", "decided", "dec_ok", "fallback",
            "nonfinite", "rt", "failed", "stage_clk", "clock", "interf",
            "fit_skipped")


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


@pytest.fixture(scope="module")
def twins():
    """Both packages' fixture fleets, their plans and fused campaigns."""
    jexps, exps = [], []
    for key, seed, scenario in JOBS:
        jex = JExperiment(key, seed=seed, candidate_stride=4,
                          scenario=jmake_scenario(scenario))
        ex = JobExperiment(key, seed=seed, candidate_stride=4, device="cpu",
                           scenario=make_scenario(scenario),
                           ae_params=_np(jex.encoder.ae_params))
        init = _np(jmodel.init_enel(jax.random.PRNGKey(seed)))
        ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
        ex.trainer.params = enel_params_from_numpy(init, device="cpu")
        _no_dropout(jex.trainer)
        _no_dropout(ex.trainer)
        jexps.append(jex)
        exps.append(ex)
    JFleet(jexps, JService(seed=3), engine="batched").profile(PROFILE_RUNS)
    FleetCampaign(exps, DecisionService(seed=3),
                  engine="batched").profile(PROFILE_RUNS)
    jexps[0].chaos = JChaos(JSpec(name="t", nan_fit_every=2), exp_seed=7)
    exps[0].chaos = ChaosInjector(ChaosSpec(name="t", nan_fit_every=2),
                                  exp_seed=7)
    jplan = jck.build_plan(jexps, N_RUNS, metric_dropout=0.0)
    plan = ck.build_plan(exps, N_RUNS, metric_dropout=0.0)
    jcarry, jys = jck.run_fused(jplan)
    carry, ys = ck.run_fused(plan)
    return dict(jplan=jplan, plan=plan, jcarry=_np(jcarry), jys=_np(jys),
                carry=ck.carry_to_host(carry), ys=ys, jexps=jexps, exps=exps)


@pytest.fixture(scope="module")
def scratch_twins(twins):
    """Both fleets' campaigns again, with ``retrain_every=2``: after
    profiling ``runs_seen`` is 0, so run 2 of 3 retrains from scratch (the
    fixture's cadence of 5 never does in 3 runs).  The plans draw their run
    blocks after ``twins``' plans on both sides alike.  Each side runs one
    run at a time (one compile of the reference's scan), to hold the carry
    after the scratch fit."""
    jplan = jck.build_plan(twins["jexps"], N_RUNS, retrain_every=2,
                           metric_dropout=0.0)
    plan = ck.build_plan(twins["exps"], N_RUNS, retrain_every=2,
                         metric_dropout=0.0)
    c_max, out = plan.static.c_max, dict(jplan=jplan, plan=plan)
    jcarry = carry = None
    jys, ys = [], []
    for r in range(N_RUNS):
        jcarry, jy = jck.run_fused(jplan, jcarry, r * c_max, (r + 1) * c_max)
        carry, y = ck.run_fused(plan, carry, r * c_max, (r + 1) * c_max)
        jys.append(_np(jy))
        ys.append(y)
        if r + 1 == SCRATCH_RUN:
            out.update(jmid=_np(jcarry), mid=ck.carry_to_host(carry))
    join = lambda parts: {k: np.concatenate([p[k] for p in parts])
                          for k in parts[0]}
    return dict(out, jys=join(jys), ys=join(ys))


def _host(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def test_plan_tables_equal(twins):
    jplan, plan = twins["jplan"], twins["plan"]
    want = {k: v for k, v in jplan.static._asdict().items()
            if k != "use_kernel"}   # the port's route follows the device
    assert plan.static._asdict() == want
    for key, v in jplan.dev.items():
        if key in NOT_DEVICE:
            continue
        want, got = np.asarray(v), _host(plan.dev[key])
        assert got.shape == want.shape, key
        if key in CONTEXT_TABLES:
            np.testing.assert_allclose(got, want, rtol=0, atol=CTX_ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    for key in ("any_decide", "scratch_at", "poison_at"):
        np.testing.assert_array_equal(plan.host[key],
                                      np.asarray(jplan.dev[key]), key)
    for key, v in jplan.host.items():
        np.testing.assert_array_equal(np.asarray(plan.host[key]),
                                      np.asarray(v), err_msg=key)
    for got, want in zip(param_leaves(plan.dev["init_params"]),
                         jax.tree_util.tree_leaves(
                             jplan.dev["init_params"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    init = ck.carry_to_host(ck.init_carry(plan))
    for key in ("pos", "count", "slot_ok"):
        np.testing.assert_array_equal(init["ring"][key],
                                      np.asarray(jplan.init["ring"][key]))
    for key, v in jplan.init["ring"]["buffers"].items():
        np.testing.assert_allclose(init["ring"]["buffers"][key],
                                   np.asarray(v), rtol=0, atol=CTX_ATOL,
                                   err_msg=key)


def test_campaign_outputs_equal(twins):
    jys, ys = twins["jys"], twins["ys"]
    assert set(ys) == set(jys)
    for key in EXACT_YS:
        np.testing.assert_array_equal(ys[key], jys[key], err_msg=key)
    assert ys["fallback"].any() and ys["decided"].any()
    np.testing.assert_allclose(ys["fit_loss"], jys["fit_loss"], **FIT_TOL)
    for key in ys:
        if key.startswith("tel_"):
            np.testing.assert_array_equal(ys[key], jys[key], err_msg=key)
    c, jc = twins["carry"], twins["jcarry"]
    for key in ("fallbacks", "nonfinite", "fit_calls", "clock", "interf",
                "s_prev", "s_cur", "p_a", "p_z", "p_met"):
        np.testing.assert_array_equal(c[key], jc[key], err_msg=key)
    for got, want in zip(param_leaves(c["params"]),
                         jax.tree_util.tree_leaves(jc["params"])):
        np.testing.assert_allclose(got, want, **FIT_TOL)


def test_scratch_fit_matches_reference(scratch_twins):
    """The scratch branch of the fit: parameters from ``init_params``,
    zeroed moments and step count, the whole ring weighted by ``slots <
    count & slot_ok`` and ``scratch_steps`` Adam steps, against the
    reference's, and run 3 deciding with the scratch model.

    The parameters are held at the end of the scratch run.  At the end of
    the campaign they are not: run 3's fine-tune of the gbt job parts at its
    29th Adam step, where f1's hidden unit 23 has its pre-activation at one
    node of a tune row within float32 drift of zero (+1.07e-5 in the port,
    -5.22e-5 in the reference, of a range of 3.3), so the leaky ReLU's
    slope there (1 or 0.1) differs and that unit's column of f1[0].w leaves
    the tolerance.  It is the kind of split the K-Means scratch retrain
    shows (``tests/test_torch_training.py``, ``KMEANS_SPLIT_STEP``)."""
    plan, jplan = scratch_twins["plan"], scratch_twins["jplan"]
    np.testing.assert_array_equal(plan.host["scratch_at"],
                                  [False, True, False])
    np.testing.assert_array_equal(plan.host["scratch_at"],
                                  np.asarray(jplan.dev["scratch_at"]))
    jys, ys = scratch_twins["jys"], scratch_twins["ys"]
    for key in EXACT_YS:
        np.testing.assert_array_equal(ys[key], jys[key], err_msg=key)
    np.testing.assert_allclose(ys["fit_loss"], jys["fit_loss"], **FIT_TOL)
    assert repr(materialize_fused(plan, ys)) == \
        repr(jmaterialize(jplan, jys))
    c, jc = scratch_twins["mid"], scratch_twins["jmid"]
    # the Adam step count restarts at the scratch fit: its steps, less the
    # steps skipped
    fit_t = SCRATCH_RUN * plan.static.c_max - 1
    np.testing.assert_array_equal(c["opt"][2], jc["opt"][2])
    np.testing.assert_array_equal(
        c["opt"][2], plan.static.scratch_steps - ys["fit_skipped"][fit_t])
    port = [param_leaves(t) for t in (c["params"], *c["opt"][:2])]
    ref = [jax.tree_util.tree_leaves(t)
           for t in (jc["params"], *jc["opt"][:2])]
    for got, want in zip(sum(port, []), sum(ref, [])):
        np.testing.assert_allclose(got, want, **FIT_TOL)


def test_materialized_stats_equal(twins):
    assert repr(materialize_fused(twins["plan"], twins["ys"])) == \
        repr(jmaterialize(twins["jplan"], twins["jys"]))


# ------------------------------------------------------ the guardrail's pick
_TOTAL = st.one_of(st.sampled_from([math.nan, math.inf, -math.inf, 50.0,
                                    50.0, 80.0]),
                   st.floats(0.0, 200.0, width=32))
_SCALAR = st.one_of(st.sampled_from([math.nan, math.inf, -math.inf, 0.0,
                                     -1.0]),
                    st.integers(1, 200).map(float),
                    st.floats(0.0, 200.0, width=32))


@st.composite
def _pick_inputs(draw):
    real = sorted(draw(st.sets(st.integers(1, 40), min_size=1, max_size=9)))
    c_pad = draw(st.integers(len(real), 12))
    cand = real + [real[-1]] * (c_pad - len(real))
    valid = draw(st.lists(st.booleans(), min_size=len(real),
                          max_size=len(real)))
    valid[draw(st.integers(0, len(real) - 1))] = True
    valid += [False] * (c_pad - len(real))
    totals = draw(st.lists(_TOTAL, min_size=c_pad, max_size=c_pad))
    current = draw(st.one_of(st.sampled_from([math.nan, math.inf]),
                             st.integers(0, 45).map(float)))
    return (np.array(cand, np.float32), np.array(valid),
            np.array(totals, np.float32), np.float32(current),
            np.float32(draw(_SCALAR)), np.float32(draw(_SCALAR)))


def _has_subnormal(*arrays):
    tiny = np.finfo(np.float32).tiny
    return any(((a != 0) & (np.abs(a) < tiny)).any()
               for a in map(np.asarray, arrays))


@settings(max_examples=150, deadline=None)
@given(_pick_inputs())
@example((np.array([4.0, 8.0, 12.0], np.float32), np.array([True] * 3),
          np.array([1e-45, 0.0, 50.0], np.float32), np.float32(4.0),
          np.float32(1e-44), np.float32(100.0)))
def test_fallback_pick_matches_reference_and_host_policy(inputs):
    cand, valid, totals, current, elapsed, target = inputs
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = int(fallback_pick(t(cand), t(valid), t(totals), t(current),
                            t(elapsed), t(target)))
    want = int(jfallback_pick(jnp.asarray(cand), jnp.asarray(valid),
                              jnp.asarray(totals), jnp.asarray(current),
                              jnp.asarray(elapsed), jnp.asarray(target)))
    # XLA on the CPU flushes subnormal float32 to zero, so there the
    # reference ties a total of 1e-45 with 0.0 where its own float64 host
    # policy and the port do not: such draws are held against the host
    # policy below only.
    if not _has_subnormal(totals, current, elapsed, target):
        assert got == want
    assert valid[got] or not valid.any()
    # the float64 host policy sees the same urgency band
    pol = FallbackPolicy()
    with np.errstate(all="ignore"):
        u32 = np.float32(elapsed) / np.float32(target)
    u64 = float(elapsed) / float(target) if target else math.nan
    for thr in (pol.press_lo, pol.press_hi):
        assume((u32 >= np.float32(thr)) == (u64 >= thr))
    real = [int(c) for c, v in zip(cand, valid) if v]
    pick, _ = pol.decide(real, [float(x) for x, v in zip(totals, valid) if v],
                         float(current), float(elapsed), float(target))
    assert int(cand[got]) == pick


def test_fallback_pick_job_axis():
    """A leading job axis picks each row as the row alone does."""
    rng = np.random.RandomState(0)
    cand = torch.tensor([4.0, 8.0, 12.0, 16.0, 20.0, 20.0])
    valid = torch.tensor([True] * 5 + [False])
    totals = torch.tensor(rng.uniform(50, 150, (6, 6)).astype(np.float32))
    totals[1] = math.nan
    totals[2, :3] = math.inf
    totals[3] = totals[3, 0]                     # ties
    current = torch.tensor([4.0, 12.0, math.nan, 8.0, 36.0, 16.0])
    elapsed = torch.tensor([10.0, 90.0, 50.0, math.inf, 0.0, 60.0])
    target = torch.full((6,), 100.0)
    rows = fallback_pick(cand.expand(6, 6), valid.expand(6, 6), totals,
                         current, elapsed, target)
    assert rows.dtype == torch.int32
    for j in range(6):
        assert int(rows[j]) == int(fallback_pick(
            cand, valid, totals[j], current[j], elapsed[j], target[j]))
