"""The vectorized fleet engine of the PyTorch port (``BatchedClusterSim``,
the ``sim_step`` kernel's plain version on the CPU) against the reference's
``repro.sim.engine`` and the port's per-job ``NumpySimBackend``.

* ``flat_job_tables`` arrays equal the reference's for the four paper jobs
  and a skew growth;
* records bit for bit equal to the reference's batched engine (JAX on the
  CPU) and to the numpy backend: batch 1 on all four jobs, a fleet of mixed
  scenarios, ``run_full`` against the stepped engine, and a
  ``slot_state``/``restore_slot`` in the middle of a run;
* ``campaign_run_blocks`` and ``fused_sim_constants`` equal the
  reference's array for array, and so do the slot states after them;
* batched fleets: ``FleetCampaign(engine="batched")`` picks equal the
  reference's batched fleet, and a batched fleet's trace equals the same
  fleet's on the numpy engine.

The test marked ``cuda`` holds the kernel against its plain version, bit
for bit, in both entry modes; it needs an NVIDIA card and ``nvcc`` and
skips without them; on a machine with a card: ``python -m pytest -m cuda
tests/test_torch_sim_engine.py``.  That machine has no JAX, so the
reference is imported inside a fixture, not by the module.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.dataflow import FleetCampaign, JobExperiment
from repro_torch.dataflow.workloads import JOBS
from repro_torch.kernels import build
from repro_torch.kernels.sim_step import ops
from repro_torch.sim.engine import (BatchedClusterSim, NumpySimBackend,
                                    SimStepRequest)
from repro_torch.sim.evaluate import DEFAULT_JOBS, DEFAULT_SCENARIOS
from repro_torch.sim.scenarios import make_scenario
from repro_torch.sim.tables import flat_job_tables

MIXED = [("lr", "stragglers"), ("mpc", "interference_burst"),
         ("kmeans", "spot_preemption"), ("gbt", "data_skew_drift")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the eager ops are tiny, and test processes
    sharing a host's cores slow one another down with full pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    from repro.dataflow import workloads
    from repro.sim import engine, scenarios, tables
    return SimpleNamespace(engine=engine, scenarios=scenarios, tables=tables,
                           jobs=workloads.JOBS)


def _backends(ref, combos, seed0):
    """(reference batched, port batched on the CPU, port numpy) with the
    same jobs registered: ``combos`` of (job key, scenario name)."""
    out = (ref.engine.BatchedClusterSim(), BatchedClusterSim(device="cpu"),
           NumpySimBackend())
    for i, (key, scn) in enumerate(combos):
        out[0].register(ref.jobs[key], seed=seed0 + i,
                        scenario=ref.scenarios.make_scenario(scn, seed=5))
        for b in out[1:]:
            b.register(JOBS[key], seed=seed0 + i,
                       scenario=make_scenario(scn, seed=5))
    return out


def _assert_same_component(want, got, ctx):
    """Every field of every stage record equal.  ``time_fraction`` as
    float32: the batched engines write 0.8 where the per-job simulator
    writes float(F32(0.8)), and the graphs hold it as float32."""
    assert len(want.stages) == len(got.stages), ctx
    for sw, sg in zip(want.stages, got.stages):
        assert type(sg.start) is np.float32, ctx
        assert type(sg.runtime) is np.float32, ctx
        assert (sw.name, sw.start, sw.runtime, sw.start_scaleout,
                sw.end_scaleout, np.float32(sw.time_fraction), sw.overhead,
                sw.failures) == (sg.name, sg.start, sg.runtime,
                                 sg.start_scaleout, sg.end_scaleout,
                                 np.float32(sg.time_fraction), sg.overhead,
                                 sg.failures), ctx
        np.testing.assert_array_equal(sw.metrics, sg.metrics, err_msg=ctx)


def _drive(backends, n_jobs, comps, rng, inject=True, clocks=None,
           s_prev=None, begin=True):
    """Step every backend through one schedule from component ``comps[0]``
    on; the first backend's results are the reference for the others.
    Returns the observed kill seconds and each job's (clock, scale-out)."""
    port = next(b for b in backends if isinstance(b, BatchedClusterSim))
    jobs = [port._slots[j].job for j in range(n_jobs)]
    if begin:
        for b in backends:
            for j in range(n_jobs):
                b.begin_run(j)
    clocks = clocks or [0.0] * n_jobs
    s_prev = s_prev or [int(rng.choice([8, 16, 33]))] * n_jobs
    s_cur = list(s_prev)
    fails = 0
    for k in comps:
        idxs = [j for j in range(n_jobs) if k < jobs[j].n_components]
        results = [b.step([SimStepRequest(j, k, s_prev[j], s_cur[j],
                                          clocks[j], inject) for j in idxs])
                   for b in backends]
        for pos, j in enumerate(idxs):
            want = results[0][pos]
            for got in (res[pos] for res in results[1:]):
                ctx = f"comp={k} job={jobs[j].name}"
                _assert_same_component(want.component, got.component, ctx)
                assert want.failures == got.failures, ctx
                assert np.float32(want.clock_end) == \
                    np.float32(got.clock_end), ctx
            fails += len(want.failures)
            clocks[j] = want.clock_end
            s_prev[j] = s_cur[j]
            s_cur[j] = int(rng.choice([4, 8, 16, 24, 36]))
    return fails, clocks, s_cur


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("key,growth", [(k, 1.0) for k in DEFAULT_JOBS] +
                         [("gbt", 1.04)])
def test_flat_job_tables_match_jax(ref, key, growth):
    got = flat_job_tables(JOBS[key], growth)
    want = ref.tables.flat_job_tables(ref.jobs[key], growth)
    assert got.names == want.names
    assert got.total_stages == want.total_stages
    for f in ("comp_of", "first_of_comp", "comp_start", "n_stages", "rt",
              "sq", "slow", "cpu0", "shuffle0", "io0"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_flat_job_tables_sizes():
    """T (stages of a run) and S (most stages of one component) per job."""
    sizes = {k: (flat_job_tables(JOBS[k]).total_stages,
                 int(flat_job_tables(JOBS[k]).n_stages.max()))
             for k in DEFAULT_JOBS}
    assert sizes == {"lr": (63, 3), "mpc": (63, 3), "kmeans": (23, 2),
                     "gbt": (53, 5)}


# ------------------------------------------------------ records, bit parity
@pytest.mark.parametrize("i,key", list(enumerate(DEFAULT_JOBS)))
def test_batch1_matches_jax_and_numpy(ref, i, key):
    """Batch 1 on each paper job, failures injected, random rescale
    schedules, two runs: three engines, the same records bit for bit."""
    backends = _backends(ref, [(key, "node_failure")], 40 + i)
    rng = np.random.RandomState(7 + i)
    fails = sum(_drive(backends, 1, range(JOBS[key].n_components), rng)[0]
                for _ in range(2))
    assert fails > 0
    assert backends[1].dispatches == backends[0].dispatches == \
        2 * JOBS[key].n_components


def test_mixed_scenario_fleet_matches_jax_and_numpy(ref):
    """One batched backend, four jobs, four different scenarios riding the
    same launches."""
    backends = _backends(ref, MIXED, 60)
    rng = np.random.RandomState(11)
    c_max = max(JOBS[k].n_components for k, _ in MIXED)
    for _ in range(2):
        _drive(backends, len(MIXED), range(c_max), rng)
    assert backends[1].dispatches == 2 * c_max


def test_run_full_matches_stepped(ref):
    """The whole-run launch against the reference's whole-run dispatch and
    the numpy backend stepped component by component."""
    combos = [("kmeans", "node_failure"), ("gbt", "node_failure"),
              ("kmeans", "stragglers")]
    jb, pb, nb = _backends(ref, combos, 80)
    rng = np.random.RandomState(1)
    c_max = max(JOBS[k].n_components for k, _ in combos)
    a = rng.choice([8, 16, 24], (len(combos), c_max)).astype(np.int32)
    z = rng.choice([8, 16, 24, 36], (len(combos), c_max)).astype(np.int32)
    want = jb.run_full(a, z, inject_failures=True)
    got = pb.run_full(a, z, inject_failures=True)
    assert pb.dispatches == 1
    for j, (key, _) in enumerate(combos):
        nb.begin_run(j)
        clock, fails = 0.0, []
        for c in range(JOBS[key].n_components):
            r = nb.step([SimStepRequest(j, c, int(a[j, c]), int(z[j, c]),
                                        clock, True)])[0]
            clock = r.clock_end
            fails.extend(r.failures)
            for w in (want[j][0][c], r.component):
                _assert_same_component(w, got[j][0][c], f"job {j} comp {c}")
        assert fails == got[j][1] == want[j][1]
    assert sum(len(f) for _, f in got) > 0


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "rng":
            assert a[k][0] == b[k][0]
            np.testing.assert_array_equal(a[k][1], b[k][1])
            assert a[k][2:] == b[k][2:]
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert (type(a[k]), a[k]) == (type(b[k]), b[k]), k


@pytest.mark.parametrize("fresh", [False, True])
def test_restore_mid_run_resumes_identically(ref, fresh):
    """Slot states taken in the middle of a run (on stragglers, so the
    straggler stream's re-alignment shows) restore into the same engine
    after it ran on, or into a fresh one, and the run resumes to the
    records of the reference's uninterrupted run."""
    combos = [("gbt", "stragglers"), ("kmeans", "stragglers")]
    jb, pb, _ = _backends(ref, combos, 90)
    rng = np.random.RandomState(3)
    _, clocks, s_next = _drive((jb, pb), 2, range(4), rng)
    states = [pb.slot_state(j) for j in range(2)]
    for j in range(2):
        _same_state(states[j], jb.slot_state(j))
    if fresh:
        pb = _backends(ref, combos, 90)[1]
    else:                              # run on, then into a new run
        _drive((pb,), 2, range(4, 6), np.random.RandomState(0), begin=False,
               clocks=list(clocks))
        _drive((pb,), 2, range(2), np.random.RandomState(1))
    for j in range(2):
        pb.restore_slot(j, states[j])
    _drive((jb, pb), 2, range(4, 8), rng, begin=False, clocks=list(clocks),
           s_prev=s_next)


# ---------------------------------------------------------- fused campaign
def test_campaign_run_blocks_match_jax(ref):
    jb, pb, _ = _backends(ref, MIXED, 70)
    rng = np.random.RandomState(5)
    _drive((jb, pb), len(MIXED), range(3), rng)     # a run under way
    got_b, got_k = pb.campaign_run_blocks(3)
    want_b, want_k = jb.campaign_run_blocks(3)
    assert got_b.dtype == want_b.dtype and got_k.dtype == want_k.dtype
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_k, want_k)
    for j in range(len(MIXED)):
        _same_state(pb.slot_state(j), jb.slot_state(j))
    got_c, want_c = pb.fused_sim_constants(), jb.fused_sim_constants()
    assert got_c.keys() == want_c.keys()
    for k, v in want_c.items():
        g = got_c[k]
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(v))
            assert g.numpy().dtype == np.asarray(v).dtype, k
        else:
            assert g == v, k
    # the engine steps on from the blocks' state as the reference does
    _drive((jb, pb), len(MIXED), range(2), rng)


# ------------------------------------------------------------ batched fleets
def _no_dropout(trainer):
    fit = trainer.fit_resident
    trainer.fit_resident = lambda **kw: fit(**dict(kw, metric_dropout=0.0))


def _run_key(st):
    return (tuple(st.scaleouts), np.float32(st.runtime),
            np.float32(st.violation), st.n_failures, st.n_rescales,
            st.decide_calls, st.fallback_decisions, st.shed_requests)


def _fleet_stats(make_exp, make_fleet, job_keys=("kmeans", "gbt")):
    exps = [make_exp(k, seed=7 + i) for i, k in enumerate(job_keys)]
    c = make_fleet(exps)
    c.profile(2)
    return c, c.adaptive_campaign(2, "enel", True)[0]


def test_batched_fleet_matches_jax_batched_fleet():
    """``FleetCampaign(engine="batched")`` on both sides: one shared engine
    on the experiments' device, the same picks and float32 runtimes, the
    same number of launches.  The port gets the reference's auto-encoder
    weights and initial parameters, both fit without metric dropout."""
    import jax

    from repro.core import model as jmodel
    from repro.dataflow import FleetCampaign as JFleet
    from repro.dataflow import JobExperiment as JExperiment
    from repro_torch.convert import enel_params_from_numpy
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    made = []

    def jexp(key, seed):
        ex = JExperiment(key, seed=seed, candidate_stride=4)
        _no_dropout(ex.trainer)
        made.append(ex)
        return ex

    def pexp(key, seed):
        jex = made.pop(0)
        ex = JobExperiment(key, seed=seed, candidate_stride=4, device="cpu",
                           ae_params=np_tree(jex.encoder.ae_params))
        init = np_tree(jmodel.init_enel(jax.random.PRNGKey(seed)))
        ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
        ex.trainer.params = enel_params_from_numpy(init, device="cpu")
        _no_dropout(ex.trainer)
        return ex
    jc, jstats = _fleet_stats(jexp, lambda e: JFleet(e, engine="batched"))
    c, stats = _fleet_stats(pexp, lambda e: FleetCampaign(e,
                                                          engine="batched"))
    backend = c.experiments[0].backend
    assert isinstance(backend, BatchedClusterSim)
    assert backend.device == torch.device("cpu")
    assert all(ex.backend is backend for ex in c.experiments)
    assert [ex.sim_slot for ex in c.experiments] == [0, 1]
    assert [[_run_key(s) for s in run] for run in stats] == \
        [[_run_key(s) for s in run] for run in jstats]
    assert backend.dispatches == jc.experiments[0].backend.dispatches > 0
    assert sum(s.n_failures for run in stats for s in run) > 0


def test_batched_fleet_equals_numpy_fleet():
    """The engine changes nothing: a batched fleet's trace equals the same
    fleet's on the numpy engine, pick for pick, and the shared engine
    launched once per lockstep round that stepped."""
    make = lambda key, seed: JobExperiment(key, seed=seed,
                                           candidate_stride=4, device="cpu")
    c, batched = _fleet_stats(make, lambda e: FleetCampaign(e,
                                                            engine="batched"))
    _, plain = _fleet_stats(make, FleetCampaign)
    assert [[_run_key(s) for s in run] for run in batched] == \
        [[_run_key(s) for s in run] for run in plain]
    backend = c.experiments[0].backend
    # profile(2) steps one job at a time, the campaign both at once
    profile = 2 * sum(ex.job.n_components for ex in c.experiments)
    assert profile < backend.dispatches < profile + 2 * sum(
        ex.job.n_components for ex in c.experiments)


# -------------------------------------------------------------------- card
@pytest.fixture
def card():
    """The CUDA card and nvcc, or a skip naming what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    try:
        build.find_nvcc()
    except RuntimeError as err:
        pytest.skip(f"needs nvcc: {err}")
    return torch.device("cuda")


def _fleet_engine(device, n, inject=True):
    """A batched engine over ``n`` jobs cycled over the four classes and the
    six default scenarios, one run begun."""
    b = BatchedClusterSim(device=device)
    for i in range(n):
        b.register(JOBS[DEFAULT_JOBS[i % 4]], seed=100 + i,
                   scenario=make_scenario(DEFAULT_SCENARIOS[i % 6], seed=1,
                                          inject_failures=inject))
    b._build()
    for j in range(n):
        b.begin_run(j)
    return b


def _step_args(b, rng):
    """A stepped launch's inputs: every job at its first component."""
    ctrl = np.zeros((b._J, ops.N_CTRL), np.float32)
    ctrl[:, 1] = rng.rand(b._J) * 0.4
    ctrl[:, 2] = rng.choice([4, 8, 16], b._J)
    ctrl[:, 3] = rng.choice([8, 16, 24, 36], b._J)
    ctrl[:, 4] = 1
    ctrl[:, 5] = [s.tables.n_stages[0] for s in b._slots]
    ctrl[:, 6] = 4.7
    return b._run_block(), b._consts(), b._dev(ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 24])
def test_sim_step_kernel_matches_plain_on_card(card, n):
    """Both entry modes, bit for bit against the plain version on the card,
    one launch per call, two launches bit-equal."""
    b = _fleet_engine(card, n)
    rng = np.random.RandomState(n)
    block, consts, ctrl = _step_args(b, rng)
    before = ops.LAUNCHES
    got = ops.sim_stages(block, consts, ctrl=ctrl, s_len=b._S)
    again = ops.sim_stages(block, consts, ctrl=ctrl, s_len=b._S)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, ops.sim_stages_plain(block, consts, ctrl=ctrl,
                                                 s_len=b._S))
    state = torch.tensor(rng.rand(n, 2).astype(np.float32) * 0.4,
                         device=card)
    ipack = torch.tensor(rng.choice([4, 12, 36], (b._T, n, 2)).astype(
        np.int32), device=card)
    valid = torch.tensor(rng.rand(b._T, n) < 0.9, device=card)
    got = ops.sim_stages(block, consts, state=state, ipack=ipack,
                         valid=valid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 3
    assert torch.equal(got, ops.sim_stages_plain(
        block, consts, state=state, ipack=ipack, valid=valid))
