"""Campaign checkpoints of the PyTorch port: a killed controller resumes
trace-identical.

The port's contracts mirror ``tests/test_checkpoint.py`` on the numpy sim
engine and on one shared batched engine: a ``FleetCampaign`` killed at a
lockstep round and restored from its latest checkpoint (pickled to disk
and loaded back, also in a fresh process) produces exactly the trace of an
uninterrupted campaign;
checkpointing changes nothing; ``JobExperiment`` snapshots restore any
number of times, into fresh tensors, so the decision service's stack memo
cannot serve stale parameters.  The checkpoint's building blocks
(``TrainingCache.snapshot``, ``ClusterSim.state_dict``) are byte-equal to
the reference's on the same history.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.service import DecisionService
from repro_torch.dataflow import FleetCampaign, JobExperiment
from repro_torch.dataflow.fleet import CampaignCheckpoint
from repro_torch.sim.engine import BatchedClusterSim, SimStepRequest

FOUR_JOBS = ("lr", "mpc", "kmeans", "gbt")
TWO_JOBS = ("kmeans", "gbt")
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager ops are tiny, and test processes
    sharing a host's cores slow one another down with full pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PROFILED = {}


def _campaign(job_keys, seed=7, stride=4, engine="numpy"):
    """A fresh campaign over experiments after ``profile(2)``, on the numpy
    engine or on one shared batched engine.  The first campaign of a kind
    profiles; later ones restore its snapshots (the scratch fit dominates a
    test's time on the CPU)."""
    exps = [JobExperiment(k, seed=seed + i, candidate_stride=stride,
                          device="cpu", engine=engine)
            for i, k in enumerate(job_keys)]
    c = FleetCampaign(exps, DecisionService(seed=3),
                      engine="batched" if engine == "batched" else None)
    key = (tuple(job_keys), seed, stride, engine)
    if key not in _PROFILED:
        c.profile(2)
        _PROFILED[key] = [exp.snapshot_state() for exp in exps]
    else:
        for exp, st in zip(exps, _PROFILED[key]):
            exp.restore_state(st)
    return c


def _trace(all_stats):
    """Runtimes and violations as float32, the rest exactly."""
    return [(np.float32(s.runtime), np.float32(s.violation),
             tuple(s.scaleouts), s.n_failures, s.n_rescales,
             s.fallback_decisions, s.shed_requests)
            for run in all_stats for s in run]


def _kill_and_resume(job_keys, tmp_path, engine="numpy"):
    ref, _ = _campaign(job_keys, engine=engine).adaptive_campaign(
        2, "enel", True)
    crash = _campaign(job_keys, engine=engine)
    out, ckpts = crash.adaptive_campaign(2, "enel", True,
                                         checkpoint_every=1,
                                         stop_after_round=3)
    assert out is None and ckpts           # crashed, checkpoints taken
    assert ckpts[-1].mid_run and ckpts[-1].round_idx == 3
    path = tmp_path / "campaign.ckpt"
    ckpts[-1].save(str(path))
    loaded = CampaignCheckpoint.load(str(path))
    assert loaded.mid_run == ckpts[-1].mid_run
    assert loaded.round_idx == ckpts[-1].round_idx
    resumed, _ = crash.resume_adaptive_campaign(loaded)
    assert _trace(resumed) == _trace(ref)


# ---------------------------------------------- kill + restore == unbroken
def test_two_job_campaign_killed_at_round3_resumes_identically(tmp_path):
    """Controller killed after 3 lockstep rounds, restored from its last
    checkpoint after a pickle round trip: the completed campaign matches
    an uninterrupted one exactly."""
    _kill_and_resume(TWO_JOBS, tmp_path)


@pytest.mark.slow
def test_four_job_campaign_killed_at_round3_resumes_identically(tmp_path):
    _kill_and_resume(FOUR_JOBS, tmp_path)


def test_two_job_batched_campaign_killed_at_round3_resumes_identically(
        tmp_path):
    """The same on one shared batched engine (the reference's own
    checkpoint contract runs there): the mid-run generators replay, then
    the shared engine's slots are pinned to their checkpoint-time state
    and re-pack their run block at the next launch."""
    _kill_and_resume(TWO_JOBS, tmp_path, engine="batched")


def test_checkpointing_is_observer_free():
    """checkpoint_every=1 and checkpoint_every=0 give identical stats:
    snapshotting perturbs no rng stream, cache or model state."""
    plain, _ = _campaign(TWO_JOBS).adaptive_campaign(2, "enel", False)
    ckpt, cks = _campaign(TWO_JOBS).adaptive_campaign(2, "enel", False,
                                                      checkpoint_every=1)
    assert len(cks) > 1
    assert _trace(plain) == _trace(ckpt)


def test_resilient_campaign_survives_multiple_crashes():
    plain, _ = _campaign(TWO_JOBS).adaptive_campaign(3, "enel", True)
    hard, restores = _campaign(TWO_JOBS).adaptive_campaign_resilient(
        3, "enel", True, crash_rounds=(2, 5), checkpoint_every=1)
    assert restores == 2
    assert _trace(hard) == _trace(plain)


def test_arrival_campaign_crash_resume_matches():
    kw = dict(pool_size=40, arrival_rate=1.2, inject_failures=False,
              seed=11, max_rounds=48)
    ref_stats, ref_trace = _campaign(("kmeans", "gbt", "lr"),
                                     seed=21).arrival_campaign(**kw)
    c = _campaign(("kmeans", "gbt", "lr"), seed=21)
    out, _ = c.arrival_campaign(**kw, checkpoint_every=2,
                                stop_after_round=5)
    assert out is None and c.checkpoints
    stats, trace = c.resume_arrival_campaign(c.checkpoints[-1])
    assert _trace([stats]) == _trace([ref_stats])
    rows = lambda tr: [(t.round_idx, t.arrivals, t.active, t.pool_used,
                        t.capped_decisions) for t in tr]
    assert rows(trace) == rows(ref_trace)


def test_pickled_checkpoint_loads_in_a_fresh_process(tmp_path):
    """A saved checkpoint holds host data only: a new process loads it with
    plain ``pickle.load`` and finds numpy parameters in it."""
    c = _campaign(("gbt",), seed=5)
    _, ckpts = c.adaptive_campaign(1, "enel", False, checkpoint_every=2,
                                   stop_after_round=2)
    path = tmp_path / "c.ckpt"
    ckpts[-1].save(str(path))
    script = (
        "import pickle, sys, numpy as np\n"
        "ck = pickle.load(open(sys.argv[1], 'rb'))\n"
        "st = ck.exps[0]['state']['trainer']\n"
        "assert isinstance(st['params']['f1'][0]['w'], np.ndarray)\n"
        "assert isinstance(st['cache']['buffers']['context'], np.ndarray)\n"
        "print(ck.kind, ck.round_idx, len(ck.exps[0]['log']))\n")
    out = subprocess.run([sys.executable, "-c", script, str(path)],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["adaptive", "2", "2"]


# ------------------------------------------------------- state round-trips
def test_job_experiment_snapshot_restore_roundtrip():
    """restore_state + an adaptive run reproduces the run the original
    experiment would have done; the snapshot stays pristine."""
    a = JobExperiment("gbt", seed=5, candidate_stride=4, device="cpu")
    a.profile(2)
    snap = a.snapshot_state()
    ref = a.adaptive_run("enel", inject_failures=True)
    a.restore_state(snap)
    again = a.adaptive_run("enel", inject_failures=True)
    assert np.float32(again.runtime) == np.float32(ref.runtime)
    assert again.scaleouts == ref.scaleouts
    # the checkpoint stayed pristine: restore twice, same result
    a.restore_state(snap)
    third = a.adaptive_run("enel", inject_failures=True)
    assert third.scaleouts == ref.scaleouts
    assert np.float32(third.runtime) == np.float32(ref.runtime)


def test_batched_job_experiment_snapshot_restore_roundtrip():
    """The single-job checkpoint contract on the batched engine: restored
    twice, the same run twice, through one launch per component."""
    a = JobExperiment("gbt", seed=5, engine="batched", candidate_stride=4,
                      device="cpu")
    assert isinstance(a.backend, BatchedClusterSim)
    a.profile(2)
    snap = a.snapshot_state()
    before = a.backend.dispatches
    ref = a.adaptive_run("enel", inject_failures=True)
    assert a.backend.dispatches == before + a.job.n_components
    for _ in range(2):
        a.restore_state(snap)
        again = a.adaptive_run("enel", inject_failures=True)
        assert np.float32(again.runtime) == np.float32(ref.runtime)
        assert again.scaleouts == ref.scaleouts
        assert again.n_failures == ref.n_failures


def test_trainer_snapshot_is_a_host_copy():
    """The Adam step updates the params in place: a snapshot must not
    change when the trainer trains on."""
    a = JobExperiment("kmeans", seed=3, candidate_stride=4, device="cpu")
    a.profile(2)
    st = a.trainer.snapshot_state()
    w0 = st["params"]["f2"][0]["w"].copy()
    a.trainer.fit_resident(steps=8)
    assert np.array_equal(st["params"]["f2"][0]["w"], w0)
    assert not np.array_equal(
        a.trainer.params["f2"][0]["w"].numpy(), w0)


def test_restore_leaves_no_stale_service_stack():
    """Snapshot, fine-tune, restore, decide: the service's stack memo
    (keyed on tensor identity and version) must not serve the fine-tuned
    parameters' stack after the restore, so the totals equal those decided
    before the fine-tune."""
    a = JobExperiment("kmeans", seed=3, candidate_stride=4, device="cpu")
    a.profile(2)
    snap = a.snapshot_state()

    def first_decision():
        gen = a.adaptive_run_gen("enel", False)
        req = next(gen)
        while isinstance(req, SimStepRequest):
            req = gen.send(a.backend.step([req])[0])
        return a.service.decide([req])[0].totals

    a.restore_state(snap)
    before = first_decision()
    a.restore_state(snap)
    a.trainer.fit_resident(steps=64, latest_only=True, metric_dropout=0.0)
    assert first_decision() != before      # the tuned params, in place
    a.restore_state(snap)
    assert first_decision() == before


def test_batched_entry_points_build_a_shared_backend():
    """``JobExperiment(engine="batched")`` gets a batched engine of its
    own on its device; ``FleetCampaign(engine="batched")`` re-registers
    every experiment on ONE shared engine, in order, and refuses a fleet
    whose experiments live on several devices or have run already."""
    one = JobExperiment("gbt", device="cpu", engine="batched")
    assert isinstance(one.backend, BatchedClusterSim)
    assert one.backend.device == torch.device("cpu") and one.sim_slot == 0
    exps = [JobExperiment(k, seed=i, device="cpu")
            for i, k in enumerate(TWO_JOBS)]
    c = FleetCampaign(exps, engine="batched")
    shared = exps[0].backend
    assert isinstance(shared, BatchedClusterSim)
    assert all(ex.backend is shared for ex in c.experiments)
    assert [ex.sim_slot for ex in exps] == [0, 1]
    assert [s.job for s in shared._slots] == [ex.job for ex in exps]
    with pytest.raises(ValueError, match="unknown engine"):
        JobExperiment("gbt", device="cpu", engine="jax")
    meta = JobExperiment("gbt", device="cpu")
    meta.trainer.device = torch.device("meta")
    with pytest.raises(AssertionError, match="one device"):
        FleetCampaign([one, meta], engine="batched")
    ran = JobExperiment("gbt", device="cpu")
    ran._run_idx = 1
    with pytest.raises(AssertionError, match="before any runs"):
        FleetCampaign([ran], engine="batched")


# --------------------------------------------- byte parity with the reference
def test_training_cache_snapshot_matches_jax_byte_for_byte():
    """The same run history in both packages' rings: the port's snapshot is
    byte-equal to the reference's, and a ring rebuilt from either snapshot
    snapshots to the same bytes again."""
    pytest.importorskip("jax")
    from repro.core import graph as jgraph
    from repro.dataflow import runner as jrunner
    from repro_torch.core.graph import TrainingCache
    jex = jrunner.JobExperiment("gbt", seed=2, candidate_stride=4)
    jex.calibrate_target(3)
    jst = jex.trainer.cache.snapshot()
    tc = TrainingCache(jst["capacity"], device="cpu")
    n = jex.job.n_components                      # one extend per run
    for r in range(0, len(jex.graph_history), n):
        tc.extend([_port_graph(g) for g in jex.graph_history[r:r + n]])
    st = tc.snapshot()
    _assert_snapshot_equal(st, jst)
    _assert_snapshot_equal(
        TrainingCache.from_snapshot(jst, device="cpu").snapshot(), jst)
    _assert_snapshot_equal(
        jgraph.TrainingCache.from_snapshot(st).snapshot(), st)


def _port_graph(g):
    from repro_torch.core.graph import ComponentGraph
    return ComponentGraph(**{k: getattr(g, k)
                             for k in ComponentGraph.__dataclass_fields__})


def _assert_snapshot_equal(got, want):
    assert set(got) == set(want)
    for k in ("capacity", "max_nodes", "pos", "count", "quarantined"):
        assert got[k] == want[k], k
    for k in ("latest", "slot_ok"):
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert set(got["buffers"]) == set(want["buffers"])
    for k, v in want["buffers"].items():
        mine = got["buffers"][k]
        assert isinstance(mine, np.ndarray), k
        assert mine.dtype == v.dtype and mine.shape == v.shape, k
        assert mine.tobytes() == np.asarray(v).tobytes(), k


def test_cluster_sim_state_dict_matches_jax_byte_for_byte():
    """The same seeded run history on both simulators: equal state dicts,
    rng state and float32 AR(1) carry included, and a simulator loaded from
    the reference's state steps on identically."""
    pytest.importorskip("jax")
    from repro.dataflow.simulator import ClusterSim as JClusterSim
    from repro.dataflow.workloads import JOBS as JJOBS
    from repro_torch.dataflow.simulator import ClusterSim
    from repro_torch.dataflow.workloads import JOBS
    js, ps = JClusterSim(seed=4), ClusterSim(seed=4)
    for sim, jobs in ((js, JJOBS), (ps, JOBS)):
        for run in range(2):
            sim.begin_run()
            clock = 0.0
            for k in range(3):
                comp = sim.run_component(jobs["kmeans"], k, clock=clock,
                                         start_scaleout=8, end_scaleout=12,
                                         inject_failures=True,
                                         failures_log=[])
                clock = float(comp.stages[-1].start + comp.stages[-1].runtime)
    jst, st = js.state_dict(), ps.state_dict()
    assert set(st) == set(jst)
    assert pickle.dumps(st) == pickle.dumps(jst)
    fresh = ClusterSim(seed=4)
    fresh.load_state_dict(jst)
    fresh.begin_run()
    js.begin_run()
    a = fresh.run_component(JOBS["gbt"], 0, clock=0.0, start_scaleout=4,
                            end_scaleout=4, inject_failures=True,
                            failures_log=[])
    b = js.run_component(JJOBS["gbt"], 0, clock=0.0, start_scaleout=4,
                         end_scaleout=4, inject_failures=True,
                         failures_log=[])
    assert [s.runtime for s in a.stages] == [s.runtime for s in b.stages]
