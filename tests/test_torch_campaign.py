"""The fused whole-campaign driver of the PyTorch port
(``repro_torch.core.campaign_kernel``): parity, grounding, checkpointing,
guardrails, telemetry.

The port's twin of ``tests/test_fused_campaign.py`` (and of the fused cases
of ``tests/test_obs.py``), on the CPU:

* ``run_fused == run_stepped`` bit-exact: both drivers run the same step
  body, one enqueueing every step before it copies the outputs to the
  host, the other copying each step's outputs;
* the fused sim is grounded in the engine: replaying the fused z-schedule
  through ``BatchedClusterSim.run_full`` on a twin fleet reproduces the
  stage runtimes and clocks bit-exactly (same rng stream contract);
* a mid-campaign checkpoint, pickled and resumed, materializes identical
  traces, and ``FleetCampaign.fused_campaign`` writes back a state the
  stepped path continues from;
* the guardrails keep every decision finite under ``nan_fit`` chaos;
* the signature count is bounded: a second campaign with the same static
  plan shape adds none; ``telemetry=False`` gives the same outputs without
  the ``tel_*`` entries, and the fused and stepped drivers replay to the
  same span stream.

A fleet's profiling dominates the CPU time, so each fleet configuration
profiles once; later fleets of that configuration restore the snapshots
(experiment state, backend slots included).  The port's ``obs``
singletons are left as they were found.
"""
import json
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.core.campaign_kernel as ck
from repro_torch import obs
from repro_torch.core.model import trace_count
from repro_torch.core.service import DecisionService
from repro_torch.dataflow import FleetCampaign, JobExperiment
from repro_torch.dataflow.fleet import FusedCheckpoint, materialize_fused
from repro_torch.sim.chaos import ChaosInjector, ChaosSpec
from repro_torch.sim.scenarios import make_scenario

# three adaptive runs after profile(3): the trainers have seen no adaptive
# run, so the cadence (a scratch fit every 5th) fine-tunes after each; the
# nan_fit injector (seed 7, every=2) poisons right after run 2's fit, so
# run 3's decisions exercise the fallback guardrail
N_RUNS = 3
PROFILE_RUNS = 3

FIXTURE_JOBS = dict(job_keys=("kmeans", "gbt", "kmeans"), seeds=(7, 8, 7),
                    scenarios=("node_failure", "baseline", "node_failure"),
                    chaos_on=(0,))


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
    """The port's obs registry, recorder and gate as on entry: series made
    by the test are dropped and the others restored."""
    saved = (obs.registry().snapshot(), obs.recorder().state(),
             obs.enabled())
    yield
    snap, rec, on = saved
    reg = obs.registry()
    for name in reg.names():
        kept = snap.get(name, {}).get("series", {})
        metric = reg.get(name)
        for key in list(metric.series()):
            if json.dumps(key) not in kept:
                metric.drop(**dict(key))
    reg.restore(snap)
    obs.recorder().load(rec)
    obs.set_enabled(on)


_PROFILED = {}


def _campaign(job_keys, seed=7, stride=4, scenarios=None, chaos_on=(),
              seeds=None):
    """A fleet on one shared batched engine after ``profile(3)``, chaos
    attached after profiling (as the chaos suite does).  The first fleet
    of a configuration profiles; its twins restore the snapshots."""
    seeds = tuple(seeds) if seeds else tuple(seed + i
                                             for i in range(len(job_keys)))
    exps = [JobExperiment(k, seed=s, candidate_stride=stride, device="cpu",
                          scenario=make_scenario(scenarios[i])
                          if scenarios else None)
            for i, (k, s) in enumerate(zip(job_keys, seeds))]
    camp = FleetCampaign(exps, DecisionService(seed=3), engine="batched")
    key = (tuple(job_keys), seeds, stride, scenarios)
    if key not in _PROFILED:
        camp.profile(PROFILE_RUNS)
        _PROFILED[key] = [e.snapshot_state() for e in exps]
    else:
        for e, st in zip(exps, _PROFILED[key]):
            e.restore_state(st)
    for i in chaos_on:
        exps[i].chaos = ChaosInjector(ChaosSpec(name="t", nan_fit_every=2),
                                      exp_seed=exps[i].seed)
    return camp


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_tree_equal(t1, t2, msg=""):
    l1, l2 = list(_leaves(t1)), list(_leaves(t2))
    assert [p for p, _ in l1] == [p for p, _ in l2], msg
    for (p, a), (_, b) in zip(l1, l2):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{msg}{p}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg}{p}")


@pytest.fixture(scope="module")
def fused_pair():
    """One 3-slot fleet (kmeans repeated with the same seed, exercising the
    class and history dedup) under node_failure and nan_fit chaos, with the
    fused and stepped drivers run over the SAME plan."""
    camp = _campaign(**FIXTURE_JOBS)
    plan = ck.build_plan(camp.experiments, N_RUNS, telemetry=True)
    c_f, ys_f = ck.run_fused(plan)
    c_s, ys_s = ck.run_stepped(plan)
    return SimpleNamespace(camp=camp, plan=plan,
                           fused=(ck.carry_to_host(c_f), ys_f),
                           stepped=(ck.carry_to_host(c_s), ys_s))


def test_fused_matches_stepped_bitwise(fused_pair):
    (c_f, ys_f), (c_s, ys_s) = fused_pair.fused, fused_pair.stepped
    _assert_tree_equal(ys_f, ys_s, "ys:")
    _assert_tree_equal(c_f, c_s, "carry:")
    assert ys_f["rt"].shape == (fused_pair.plan.n_steps,
                                fused_pair.plan.static.s_max, 3)


def test_plan_dedups_structural_tables(fused_pair):
    """Slots 0 and 2 share (job, seed), so they share one class and one
    history table: the plan carries G=2 < J=3 structural classes."""
    plan = fused_pair.plan
    assert plan.dev["obs_ctx"].shape[0] == 2
    assert plan.dev["hob_ctx"].shape[0] == 2
    np.testing.assert_array_equal(plan.dev["cls"].numpy(), [0, 1, 0])


def test_fused_chaos_guardrail(fused_pair):
    """nan_fit chaos poisons the resident params in the step; every
    decision still leaves it finite (clamped, counted) and the fallback
    pick answers at least one decision while the model is poisoned."""
    plan, (c_f, ys_f) = fused_pair.plan, fused_pair.fused
    assert (c_f["nonfinite"] == 0).all(), c_f["nonfinite"]
    assert np.isfinite(ys_f["s_next"]).all()
    assert c_f["fallbacks"][0] > 0                    # chaos-poisoned job
    assert plan.host["poison_at"].any()               # chaos actually fired
    picks = ys_f["s_next"][ys_f["decided"]]
    assert ((picks >= 4) & (picks <= 36)).all()


def test_fused_grounded_in_run_full(fused_pair):
    """Replaying the fused a/z schedule through the engine's run_full on a
    TWIN fleet reproduces stage runtimes and final clocks bit-exactly."""
    plan, (_, ys_f) = fused_pair.plan, fused_pair.fused
    twin = _campaign(**FIXTURE_JOBS)
    backend = twin.experiments[0].backend
    c_max = plan.static.c_max
    a = ys_f["a"].astype(np.int64)                    # (T, J)
    z = ys_f["z"].astype(np.int64)
    rt = ys_f["rt"]                                   # (T, s_max, J)
    clock = ys_f["clock"]
    for r in range(N_RUNS):
        t0 = r * c_max
        res = backend.run_full(a[t0:t0 + c_max].T.copy(),
                               z[t0:t0 + c_max].T.copy())
        for j, (comps, _) in enumerate(res):
            for k, comp in enumerate(comps):
                for i, stage in enumerate(comp.stages):
                    np.testing.assert_array_equal(
                        np.float32(stage.runtime), rt[t0 + k, i, j],
                        err_msg=f"run {r} job {j} comp {k} stage {i}")
            nc = twin.experiments[j].job.n_components
            np.testing.assert_array_equal(
                np.float32(backend.slot_state(j)["clock"]),
                clock[t0 + nc - 1, j])


def test_fused_checkpoint_resume_trace_identical(fused_pair, tmp_path):
    """A campaign split at a run boundary, checkpointed to disk and
    resumed, materializes the same traces as the uninterrupted run; a
    carry whose fit count disagrees with the step is refused before
    anything is enqueued, and left as it was."""
    plan, (c_f, ys_f) = fused_pair.plan, fused_pair.fused
    c_max = plan.static.c_max
    carry, ys1 = ck.run_fused(plan, None, 0, c_max)
    ckpt = FusedCheckpoint(step=c_max, n_steps=plan.n_steps,
                           carry=ck.carry_to_host(carry), ys=ys1)
    p = tmp_path / "fused.ckpt"
    ckpt.save(str(p))
    ckpt2 = FusedCheckpoint.load(str(p))
    carry2 = ck.carry_from_host(ckpt2.carry, "cpu")
    carry2, ys2 = ck.run_fused(plan, carry2, ckpt2.step, plan.n_steps)
    joined = {k: np.concatenate([ckpt2.ys[k], ys2[k]]) for k in ckpt2.ys}
    _assert_tree_equal(joined, ys_f, "resumed ys:")
    _assert_tree_equal(ck.carry_to_host(carry2), c_f, "resumed carry:")
    assert repr(materialize_fused(plan, joined)) == \
        repr(materialize_fused(plan, ys_f))
    stale = ck.carry_from_host(ckpt2.carry, "cpu")
    with pytest.raises(AssertionError, match="fit_calls"):
        ck.run_fused(plan, stale, 2 * c_max, 2 * c_max + 1)
    with pytest.raises(AssertionError, match="fit_calls"):
        ck.run_stepped(plan, stale, 2 * c_max, 2 * c_max + 1)
    _assert_tree_equal(ck.carry_to_host(stale), ckpt2.carry, "refused:")


def test_fused_signature_count_bounded(fused_pair):
    """Same static plan shape => no new signature; the count is bounded by
    the bucket-ladder rungs, not by runs or jobs."""
    plan = fused_pair.plan
    before = trace_count("fused_campaign")
    ck.run_fused(plan, stop=1)
    ck.run_stepped(plan, stop=1)
    assert trace_count("fused_campaign") == before > 0


def test_fused_campaign_entry_and_write_back():
    """FleetCampaign.fused_campaign returns adaptive_campaign-shaped stats
    and syncs model / ring / backend state so stepped runs continue after
    it (the chaos job's poisoned model included: its live decisions fall
    back)."""
    camp = _campaign(**FIXTURE_JOBS)
    exps = camp.experiments
    rings0 = [e.trainer.cache.count for e in exps]
    runs_seen0 = [e.trainer.runs_seen for e in exps]
    stats, report = camp.fused_campaign(N_RUNS)
    assert len(stats) == N_RUNS and len(stats[0]) == len(exps)
    assert (report.nonfinite == 0).all()
    for j, e in enumerate(exps):
        assert e._run_idx == PROFILE_RUNS + N_RUNS
        assert e.trainer.runs_seen == runs_seen0[j] + N_RUNS
        assert e.trainer._fit_calls == report.carry["fit_calls"][j]
        assert e.trainer.cache.count == min(
            rings0[j] + N_RUNS * e.job.n_components,
            e.trainer.cache.capacity)
        np.testing.assert_array_equal(
            e.trainer.params["attn_a"].numpy(),
            report.carry["params"]["attn_a"][j])
        for r in range(N_RUNS):
            st = stats[r][j]
            assert st.kind == "enel" and st.runtime > 0.0
            assert st.run_idx == PROFILE_RUNS + r + 1
            assert e.stats[-N_RUNS + r] is st
    # the written-back state supports continuing on the stepped path
    post = camp.adaptive_round()
    assert all(s.runtime > 0 and np.isfinite(s.runtime) for s in post)
    assert [s.run_idx for s in post] == \
        [PROFILE_RUNS + N_RUNS + 1] * len(exps)


def test_fused_campaign_checkpointed_matches_single_pass():
    camp_a = _campaign(("kmeans",), seed=21)
    stats_a, rep_a = camp_a.fused_campaign(N_RUNS, write_back=False)
    camp_b = _campaign(("kmeans",), seed=21)
    stats_b, rep_b = camp_b.fused_campaign(N_RUNS, write_back=False,
                                           checkpoint_every_runs=1)
    assert len(rep_b.checkpoints) == N_RUNS - 1
    _assert_tree_equal(rep_a.ys, rep_b.ys, "segmented ys:")
    assert repr(stats_a) == repr(stats_b)
    stats_c, rep_c = camp_b.resume_fused_campaign(
        rep_b.plan, rep_b.checkpoints[-1], write_back=False)
    _assert_tree_equal(rep_a.ys, rep_c.ys, "resumed ys:")
    _assert_tree_equal(rep_a.carry, rep_c.carry, "resumed carry:")
    assert repr(stats_a) == repr(stats_c)


def test_fused_scratch_fit_matches_stepped():
    """A cadence that retrains from scratch after run 2 restarts the job
    from its trainer's ``init_params`` with zeroed Adam moments, in both
    drivers alike."""
    camp = _campaign(("kmeans",), seed=21)
    plan = ck.build_plan(camp.experiments, 2, retrain_every=2)
    assert plan.host["scratch_at"].tolist() == [False, True]
    c_f, ys_f = ck.run_fused(plan)
    c_s, ys_s = ck.run_stepped(plan)
    _assert_tree_equal(ys_f, ys_s, "ys:")
    c_f, c_s = ck.carry_to_host(c_f), ck.carry_to_host(c_s)
    _assert_tree_equal(c_f, c_s, "carry:")
    assert (ys_f["fit_skipped"] == 0).all()
    assert c_f["opt"][2].tolist() == [plan.static.scratch_steps]
    assert c_f["fit_calls"].tolist() == \
        (plan.host["fit_calls0"] + 2).tolist()


def test_build_plan_rejections(fused_pair):
    """Each configuration the step body cannot honour is refused before
    the backend's rng streams are touched."""
    with pytest.raises(ValueError, match="empty fleet"):
        ck.build_plan([], 1)
    with pytest.raises(TypeError, match="batched sim engine"):
        ck.build_plan([JobExperiment("kmeans", device="cpu")], 1)
    exps = fused_pair.camp.experiments
    exp = exps[0]
    backend = exp.backend
    slots0 = [pickle.dumps(backend.slot_state(j)) for j in range(3)]
    chaos = exp.chaos
    exp.chaos = ChaosInjector(ChaosSpec(name="t", nan_graphs_every=2),
                              exp_seed=0)
    with pytest.raises(ValueError, match="nan_fit"):
        ck.build_plan(exps, 1)
    exp.chaos = chaos
    exp.scale_cap = 16
    with pytest.raises(ValueError, match="capacity"):
        ck.build_plan(exps, 1)
    exp.scale_cap = None
    tgt, exp.target = exp.target, None
    with pytest.raises(ValueError, match="profile"):
        ck.build_plan(exps, 1)
    exp.target = tgt
    with pytest.raises(ValueError, match="sim slots"):
        ck.build_plan(exps[::-1], 1)
    assert [pickle.dumps(backend.slot_state(j)) for j in range(3)] == slots0


def test_fused_telemetry_off_bit_exact(fused_pair):
    """telemetry=False runs the same step body without the tel block: the
    same outputs and carry as the telemetry=True plan of the same fleet,
    no tel_* outputs, and reruns add no signature."""
    (c1, ys1) = fused_pair.fused
    p0 = ck.build_plan(_campaign(**FIXTURE_JOBS).experiments, N_RUNS,
                       telemetry=False)
    c0, ys0 = ck.run_fused(p0)
    assert any(k.startswith("tel_") for k in ys1)
    assert not any(k.startswith("tel_") for k in ys0)
    _assert_tree_equal(ys0, {k: v for k, v in ys1.items()
                             if not k.startswith("tel_")}, "ys:")
    _assert_tree_equal(ck.carry_to_host(c0),
                       {k: v for k, v in c1.items() if k != "tel"},
                       "carry:")
    t0 = trace_count("fused_campaign")
    ck.run_fused(p0, stop=1)
    ck.run_fused(fused_pair.plan, stop=1)
    assert trace_count("fused_campaign") == t0


def test_fused_vs_stepped_span_parity(fused_pair):
    """Replaying the fused and stepped drivers' telemetry yields identical
    (kind, attrs) span streams, the chaos job's fallbacks included."""
    plan = fused_pair.plan
    obs.set_enabled(True)
    rec = obs.recorder()
    rec.clear()
    n_f = ck.replay_spans(plan, fused_pair.fused[1])
    stream_f = rec.stream()
    rec.clear()
    n_s = ck.replay_spans(plan, fused_pair.stepped[1])
    stream_s = rec.stream()
    rec.clear()
    assert n_f == n_s and n_f > 0
    # repr: the poisoned job's fit spans carry loss=nan, unequal to itself
    assert repr(stream_f) == repr(stream_s)
    kinds = {k for k, _ in stream_f}
    assert {"decision.pick", "decision.fallback", "fit", "run.end"} <= kinds


@pytest.mark.slow
def test_fused_matches_stepped_fleet8_scenarios():
    """The full acceptance sweep: a fleet of 8 slots covering all four
    paper jobs (each twice, sharing class tables), node_failure on half
    and nan_fit chaos on one: fused == stepped bit-exact."""
    camp = _campaign(
        ("lr", "mpc", "kmeans", "gbt") * 2,
        seeds=(11, 12, 13, 14, 11, 12, 13, 14),
        scenarios=("baseline", "node_failure", "node_failure", "baseline",
                   "baseline", "node_failure", "node_failure", "baseline"),
        chaos_on=(2,))
    plan = ck.build_plan(camp.experiments, N_RUNS)
    c_f, ys_f = ck.run_fused(plan)
    c_s, ys_s = ck.run_stepped(plan)
    _assert_tree_equal(ys_f, ys_s, "ys:")
    _assert_tree_equal(ck.carry_to_host(c_f), ck.carry_to_host(c_s),
                       "carry:")
    assert (ck.carry_to_host(c_f)["nonfinite"] == 0).all()
