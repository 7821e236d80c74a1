"""PyTorch port vs JAX reference: the training path.

Inputs come from seeded numpy and the same converted parameters go to both
packages on the CPU.  Losses and fits are held against the reference's
inline route (its own tests hold inline equal to its Pallas kernel); the
op-level VJP is held against the Pallas route in interpret mode, as
``tests/test_fit_fast_path.py`` runs it.  Tolerances are the reference's
own: gradients atol 1e-4 / rtol 1e-3 for the op and 2e-4 / 2e-3 through the
loss, fits rtol 1e-4 on the loss and atol 1e-5 / rtol 1e-4 on the params
(``tests/test_fit_fast_path.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import model as jmodel
from repro.core import training as jtraining
from repro.core.ellis import EllisScaler as JEllisScaler
from repro.kernels.graph_prop.ops import graph_prop as jgraph_prop
from repro.sim.chaos import ChaosInjector as JChaosInjector
from repro.sim.chaos import ChaosSpec as JChaosSpec
from repro_torch import convert
from repro_torch.core import graph, model, training
from repro_torch.core.ellis import EllisScaler
from repro_torch.core.graph import CTX_DIM, MAX_NODES, N_METRICS
from repro_torch.kernels.graph_prop import ops
from repro_torch.sim.chaos import ChaosInjector, ChaosSpec

FIT_LOSS_RTOL = 1e-4
FIT_ATOL, FIT_RTOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params_pair(seed):
    """(JAX params, the same as port tensors on the CPU)."""
    jp = jmodel.init_enel(jax.random.PRNGKey(seed))
    return jp, convert.enel_params_from_numpy(_np(jp), device="cpu")


def _assert_tree_close(port, ref, atol, rtol):
    """A port parameter dict against the reference pytree, leaf by leaf."""
    ref = _np(ref)
    for name in ("f1", "f2", "f3", "f4"):
        for layer, jlayer in zip(port[name], ref[name]):
            for key in ("w", "b"):
                np.testing.assert_allclose(
                    layer[key].detach().numpy(), jlayer[key], atol=atol,
                    rtol=rtol, err_msg=f"{name}.{key}")
    np.testing.assert_allclose(port["attn_a"].detach().numpy(),
                               ref["attn_a"], atol=atol, rtol=rtol)


def _random_full_batch(b, seed, n=MAX_NODES):
    """Stacked training batch over random masked DAGs (all loss targets)."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(b, n) < 0.8
    mask[:, 0] = True
    adj = np.tril(rng.rand(b, n, n) < 0.3, -1)
    return {
        "context": np.tanh(rng.randn(b, n, CTX_DIM)).astype(np.float32),
        "metrics": rng.rand(b, n, N_METRICS).astype(np.float32),
        "metrics_valid": (rng.rand(b, n) < 0.5) & mask,
        "a_raw": rng.uniform(1, 36, (b, n)).astype(np.float32),
        "z_raw": rng.uniform(1, 36, (b, n)).astype(np.float32),
        "r": rng.uniform(0.5, 1.0, (b, n)).astype(np.float32),
        "runtime": rng.uniform(1, 30, (b, n)).astype(np.float32),
        "runtime_valid": (rng.rand(b, n) < 0.7) & mask,
        "overhead": rng.uniform(0, 3, (b, n)).astype(np.float32),
        "overhead_valid": (rng.rand(b, n) < 0.3) & mask,
        "adj": adj,
        "mask": mask,
        "is_summary": (rng.rand(b, n) < 0.2) & mask,
    }


def _chain_graph(mod, k, n=4, seed=0, max_nodes=MAX_NODES, summary=False):
    """A chain of ``n`` observed stages (plus a summary predecessor)."""
    r = np.random.RandomState(100 + seed)
    nodes = [mod.NodeAttrs(f"n{i}", np.tanh(r.randn(CTX_DIM)).astype(
        np.float32), r.rand(N_METRICS).astype(np.float32), 4 + i, 8, 0.9,
        runtime=5.0 + i + r.rand(), overhead=0.5 if i == 0 else None)
        for i in range(n)]
    edges = [(i, i + 1) for i in range(n - 1)]
    if summary:
        nodes.append(mod.NodeAttrs("P", np.tanh(r.randn(CTX_DIM)).astype(
            np.float32), r.rand(N_METRICS).astype(np.float32), 8, 8,
            is_summary=True))
        edges.append((n, 0))
    return mod.build_graph(nodes, edges, k, max_nodes=max_nodes)


# ------------------------------------------------------------------ op VJP
@pytest.mark.parametrize("n,levels,b", [(4, 1, 3), (8, 8, 4), (16, 3, 2)])
def test_graph_prop_vjp_matches_jax_custom_vjp(n, levels, b):
    """Port graph_prop under autograd (and graph_prop_vjp_plain) vs the
    reference's custom VJP through its backward Pallas kernel."""
    jp, tp = _params_pair(n)
    rng = np.random.RandomState(n * 10 + levels)
    x = rng.randn(b, n, model.X_DIM).astype(np.float32)
    adj = np.tril(rng.rand(b, n, n) < 0.35, -1)
    adj[:, 1, :] = False                 # a row with no predecessor
    valid = rng.rand(b, n) < 0.4
    m = rng.rand(b, n, N_METRICS).astype(np.float32)
    ce = rng.randn(b, n, n).astype(np.float32)
    cm = rng.randn(b, n, N_METRICS).astype(np.float32)

    def scalar(p, xx, mm):
        e, mh = jgraph_prop(p, xx, jnp.asarray(adj), mm, jnp.asarray(valid),
                            levels=levels)
        return jnp.sum(e * ce) + jnp.sum(mh * cm)

    jg_p, jg_x, jg_m = jax.grad(scalar, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), jnp.asarray(m))

    ws = [w.clone().requires_grad_(True) for w in ops._weights(tp)]
    xt = torch.tensor(x, requires_grad=True)
    mt = torch.tensor(m, requires_grad=True)
    e, mh = ops.graph_prop(ops._params(ws), xt, torch.tensor(adj), mt,
                           torch.tensor(valid), levels=levels)
    got = torch.autograd.grad((e, mh), [xt, mt] + ws,
                              (torch.tensor(ce), torch.tensor(cm)))
    plain = ops.graph_prop_vjp_plain(tp, torch.tensor(x), torch.tensor(adj),
                                     torch.tensor(m), torch.tensor(valid),
                                     torch.tensor(ce), torch.tensor(cm),
                                     levels=levels)
    jf3, jf4 = _np(jg_p)["f3"], _np(jg_p)["f4"]
    ref = [np.asarray(jg_x), np.asarray(jg_m), jf3[0]["w"], jf3[0]["b"],
           jf3[1]["w"], jf3[1]["b"], np.asarray(jg_p["attn_a"]),
           jf4[0]["w"], jf4[0]["b"], jf4[1]["w"], jf4[1]["b"]]
    for i, (g, gp, r) in enumerate(zip(got, plain, ref)):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=1e-3,
                                   err_msg=str(i))
        np.testing.assert_array_equal(gp.numpy(), g.numpy())


def test_vjp_plain_zero_where_output_does_not_depend():
    """levels = 0: m_hat is m_obs, so f4 gets zero gradients and m_obs gets
    the cotangent itself."""
    _, tp = _params_pair(0)
    rng = np.random.RandomState(0)
    b, n = 2, 4
    args = (torch.tensor(rng.randn(b, n, model.X_DIM).astype(np.float32)),
            torch.tensor(np.tril(rng.rand(b, n, n) < 0.5, -1)),
            torch.tensor(rng.rand(b, n, N_METRICS).astype(np.float32)),
            torch.tensor(rng.rand(b, n) < 0.5))
    cm = torch.tensor(rng.randn(b, n, N_METRICS).astype(np.float32))
    g = ops.graph_prop_vjp_plain(tp, *args, torch.zeros(b, n, n), cm,
                                 levels=0)
    assert torch.equal(g[1], cm)
    for t in g[7:]:
        assert torch.count_nonzero(t) == 0


# -------------------------------------------------------------------- loss
_JAX_LOSS_GRAD = jax.jit(jax.value_and_grad(jtraining.enel_loss,
                                            has_aux=True),
                         static_argnums=(3,))
_JAX_ADAM_UPDATE = jax.jit(jtraining._adam_update, static_argnums=(5,))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("t_kernel", [False, True])
def test_enel_loss_and_grads_match_jax(weighted, t_kernel):
    jp, tp = _params_pair(0)
    stacked = _random_full_batch(6, seed=1)
    w = np.array([1, 0, 1, 1, 0, 1], np.float32) if weighted else None
    jbatch = {k: jnp.asarray(v) for k, v in stacked.items()}
    (jl, jparts), jg = _JAX_LOSS_GRAD(
        jp, jbatch, None if w is None else jnp.asarray(w), False)
    leaves = {id(t): t.clone().requires_grad_(True)
              for t in training.param_leaves(tp)}
    live = training.map_params(lambda t: leaves[id(t)], tp)
    tl, tparts = training.enel_loss(
        live, {k: torch.tensor(v) for k, v in stacked.items()},
        None if w is None else torch.tensor(w), use_kernel=t_kernel)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in ("runtime", "overhead", "metrics"):
        np.testing.assert_allclose(float(tparts[key].detach()),
                                   float(jparts[key]),
                                   rtol=1e-5)
    grads = training.map_params(lambda t: t.grad, live)
    _assert_tree_close(grads, jg, atol=2e-4, rtol=2e-3)


# -------------------------------------------------------------------- Adam
@pytest.fixture(scope="module")
def jax_state():
    """(JAX params, opt state) after 4 reference Adam steps, and the batch
    they trained on (numpy)."""
    jp, _ = _params_pair(0)
    stacked = _random_full_batch(4, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in stacked.items()}
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    opt = (zeros, zeros, jnp.zeros((), jnp.int32))
    jp, opt, _, _ = jtraining._adam_run(jp, opt, jbatch, 4, 5e-3, False)
    return jp, opt, stacked


def test_adam_update_matches_jax(jax_state):
    jp, jopt, stacked = jax_state
    tp = convert.enel_params_from_numpy(_np(jp), device="cpu")
    topt = convert.adam_state_from_numpy(_np(jopt), device="cpu")
    jbatch = {k: jnp.asarray(v) for k, v in stacked.items()}
    jp2, jopt2, jl, jok = _JAX_ADAM_UPDATE(jp, jopt, jbatch, 5e-3, None,
                                           False)
    tl, tok = training._adam_update(
        tp, topt, {k: torch.tensor(v) for k, v in stacked.items()}, 5e-3)
    assert bool(tok) and bool(jok)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_tree_close(tp, jp2, atol=1e-6, rtol=0)
    _assert_tree_close(topt[0], jopt2[0], atol=1e-6, rtol=0)
    _assert_tree_close(topt[1], jopt2[1], atol=1e-6, rtol=0)
    assert int(topt[2]) == int(jopt2[2]) == 5


def test_adam_guard_keeps_state_on_nan_row(jax_state):
    """A NaN batch row: ok is False and params, moments and t keep their
    values exactly (as the reference's guard does)."""
    jp, jopt, stacked = jax_state
    stacked = {k: v.copy() for k, v in stacked.items()}
    stacked["runtime"][1, 0] = np.nan
    stacked["runtime_valid"][1, 0] = True
    stacked["mask"][1, 0] = True
    stacked["is_summary"][1, 0] = False
    tp = convert.enel_params_from_numpy(_np(jp), device="cpu")
    topt = convert.adam_state_from_numpy(_np(jopt), device="cpu")
    before = [t.clone() for t in training.param_leaves(tp) +
              training.param_leaves(topt[0]) + training.param_leaves(topt[1])]
    tl, tok = training._adam_update(
        tp, topt, {k: torch.tensor(v) for k, v in stacked.items()}, 5e-3)
    *_, jok = _JAX_ADAM_UPDATE(
        jp, jopt, {k: jnp.asarray(v) for k, v in stacked.items()}, 5e-3,
        None, False)
    assert not bool(tok) and not bool(jok)
    assert not np.isfinite(float(tl))
    after = training.param_leaves(tp) + training.param_leaves(topt[0]) + \
        training.param_leaves(topt[1])
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert int(topt[2]) == 4


def test_round_steps_matches_jax():
    for s in range(1, 1001):
        assert training._round_steps(s) == jtraining._round_steps(s), s


# ---------------------------------------------------------- TrainingCache
def _cache_pair(capacity, max_nodes=8):
    return (jgraph.TrainingCache(capacity, max_nodes=max_nodes),
            graph.TrainingCache(capacity, max_nodes=max_nodes, device="cpu"))


def _assert_cache_equal(tc, jc):
    assert (tc.capacity, tc.max_nodes, tc.pos, tc.count, tc.quarantined) == \
        (jc.capacity, jc.max_nodes, jc.pos, jc.count, jc.quarantined)
    np.testing.assert_array_equal(tc.latest, jc.latest)
    np.testing.assert_array_equal(tc.slot_ok, jc.slot_ok)
    assert tc.buffers.keys() == jc.buffers.keys()
    for k, v in jc.buffers.items():
        ref = np.asarray(v)
        got = tc.buffers[k].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        assert got.tobytes() == ref.tobytes(), k


def test_training_cache_matches_jax_byte_for_byte():
    """Appends that wrap the ring, grow N 8 -> 16 and quarantine a NaN row
    leave both rings byte-identical, with equal counters."""
    jc, tc = _cache_pair(capacity=6)
    steps = [[(0, 4), (1, 3)], [(2, 5), (3, 4), (4, 6)],
             [(5, 10), (6, 4)],                    # grows to 16 slots
             [(7, 3), (8, 4), (9, 5)]]             # wraps the ring again
    for i, batch in enumerate(steps):
        gs = []
        for mod in (jgraph, graph):
            row = [_chain_graph(mod, k, n=n, seed=k, summary=k % 2)
                   for k, n in batch]
            if i == 1:                             # one poisoned row
                row[1] = dataclasses.replace(
                    row[1], runtime=row[1].runtime.copy())
                row[1].runtime[0] = np.nan
            gs.append(row)
        jidx = jc.extend(gs[0])
        tidx = tc.extend(gs[1])
        np.testing.assert_array_equal(tidx, jidx)
        _assert_cache_equal(tc, jc)
    assert tc.max_nodes == 16 and tc.quarantined == 1
    th, jh = tc.stacked_host(), jc.stacked_host()
    for k in jh:
        np.testing.assert_array_equal(th[k], jh[k], err_msg=k)
    tb, tw = tc.full_batch()
    jb, jw = jc.full_batch()
    np.testing.assert_array_equal(tw, jw)
    tb, tw = tc.latest_batch()
    jb, jw = jc.latest_batch()
    np.testing.assert_array_equal(tw, jw)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    # in-place corruption past the entry quarantine, then the sweep
    jc.buffers["metrics"] = jc.buffers["metrics"].at[2].set(jnp.nan)
    tc.buffers["metrics"][2] = float("nan")
    assert tc.quarantine_nonfinite() == jc.quarantine_nonfinite() == 1
    assert tc.quarantine_nonfinite() == jc.quarantine_nonfinite() == 0
    _assert_cache_equal(tc, jc)
    # and the converter rebuilds the port's ring from the reference's
    conv = convert.training_cache_from_numpy(
        {k: np.asarray(v) for k, v in jc.buffers.items()},
        capacity=jc.capacity, max_nodes=jc.max_nodes, pos=jc.pos,
        count=jc.count, latest=jc.latest, slot_ok=jc.slot_ok,
        quarantined=jc.quarantined, device="cpu")
    _assert_cache_equal(conv, jc)


# -------------------------------------------------------------------- fits
def _trainer_pair(seed=0, capacity=8):
    """Reference and port trainers from the same converted init."""
    jtr = jtraining.EnelTrainer(seed=seed, cache_capacity=capacity)
    tr = training.EnelTrainer(seed=seed, cache_capacity=capacity,
                              device="cpu")
    tr.init_params = convert.enel_params_from_numpy(_np(jtr.params), "cpu")
    tr.params = convert.enel_params_from_numpy(_np(jtr.params), "cpu")
    return jtr, tr


@pytest.mark.parametrize("mode", ["full", "latest_only", "from_scratch"])
def test_fit_resident_matches_jax(mode):
    jtr, tr = _trainer_pair()
    old = [(k, 3 + k % 3) for k in range(5)]
    new = [(10 + k, 4) for k in range(2)]
    for batch in (old, new):
        jtr.extend_history([_chain_graph(jgraph, k, n=n, seed=k,
                                         summary=k % 2) for k, n in batch])
        tr.extend_history([_chain_graph(graph, k, n=n, seed=k,
                                        summary=k % 2) for k, n in batch])
    kw = dict(steps=8, metric_dropout=0.0)
    if mode == "from_scratch":
        # move both away from the init first, then restart from it
        jtr.fit_resident(**kw)
        tr.fit_resident(**kw)
        kw["from_scratch"] = True
    if mode == "latest_only":
        kw["latest_only"] = True
    jl = jtr.fit_resident(**kw)
    tl = tr.fit_resident(**kw)
    np.testing.assert_allclose(tl, jl, rtol=FIT_LOSS_RTOL)
    _assert_tree_close(tr.params, jtr.params, atol=FIT_ATOL, rtol=FIT_RTOL)
    assert tr.last_skipped_steps == jtr.last_skipped_steps == 0


def test_legacy_fit_with_dropout_matches_jax():
    """The legacy route's dropout masks come from RandomState(seed +
    runs_seen), so they are the reference's bit for bit."""
    jtr, tr = _trainer_pair(seed=2)
    jg = [_chain_graph(jgraph, k, n=4, seed=k, summary=True)
          for k in range(3)]
    tg = [_chain_graph(graph, k, n=4, seed=k, summary=True)
          for k in range(3)]
    jtr.runs_seen = tr.runs_seen = 3
    jl = jtr.fit(jg, steps=8, metric_dropout=0.5)
    tl = tr.fit(tg, steps=8, metric_dropout=0.5)
    np.testing.assert_allclose(tl, jl, rtol=FIT_LOSS_RTOL)
    _assert_tree_close(tr.params, jtr.params, atol=FIT_ATOL, rtol=FIT_RTOL)


def test_fit_resident_dropout_is_seeded_and_keeps_summaries(monkeypatch):
    """The port's per-step dropout: the same seed gives the same fit, and
    summary nodes always keep their metrics."""
    seen = []
    real = training._adam_update

    def spy(params, opt, batch, lr, weights=None):
        seen.append(batch["metrics_valid"].clone())
        return real(params, opt, batch, lr, weights)

    def fit(seed):
        tr = training.EnelTrainer(seed=seed, cache_capacity=8, device="cpu")
        tr.extend_history([_chain_graph(graph, k, n=4, seed=k, summary=True)
                           for k in range(4)])
        return tr.fit_resident(steps=8, metric_dropout=0.5), tr

    monkeypatch.setattr(training, "_adam_update", spy)
    la, ta = fit(5)
    masks_a, seen[:] = list(seen), []
    lb, tb = fit(5)
    assert la == lb
    for a, b in zip(training.param_leaves(ta.params),
                    training.param_leaves(tb.params)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(masks_a, seen))
    batch, _ = ta.cache.full_batch()
    summary = batch["is_summary"]
    observed = batch["metrics_valid"]
    dropped = 0
    for mv in masks_a:
        assert torch.equal(mv[summary], observed[summary])
        assert not (mv & ~observed).any()
        dropped += int((observed & ~mv).sum())
    assert dropped > 0                     # it does drop task-set metrics


def test_fit_resident_quarantine_retry_heals_like_jax():
    """NaN written into a resident row: every step is skipped, the ring is
    swept, and the retry trains to the same loss in both packages."""
    jtr, tr = _trainer_pair(seed=4)
    jtr.extend_history([_chain_graph(jgraph, k, seed=k) for k in range(4)])
    tr.extend_history([_chain_graph(graph, k, seed=k) for k in range(4)])
    jtr.cache.buffers["metrics"] = \
        jtr.cache.buffers["metrics"].at[1].set(jnp.nan)
    tr.cache.buffers["metrics"][1] = float("nan")
    kw = dict(steps=8, from_scratch=True, metric_dropout=0.0)
    jl = jtr.fit_resident(**kw)
    tl = tr.fit_resident(**kw)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=FIT_LOSS_RTOL)
    assert tr.cache.quarantined == jtr.cache.quarantined == 1
    assert not tr.cache.slot_ok[1]
    assert tr.nonfinite_steps == jtr.nonfinite_steps == 8
    assert tr.poisoned_fits == jtr.poisoned_fits == 1
    assert tr.params_finite()
    _assert_tree_close(tr.params, jtr.params, atol=FIT_ATOL, rtol=FIT_RTOL)


def test_observe_run_resident_cadence():
    """Scratch every 5th run on the whole ring, fine-tunes in between."""
    tr = training.EnelTrainer(seed=0, cache_capacity=8, device="cpu")
    calls = []
    tr.fit_resident = lambda **kw: calls.append(kw) or 0.0
    for _ in range(5):
        tr.observe_run_resident(retrain_every=5, steps=160,
                                fine_tune_steps=60)
    assert calls[:4] == [dict(steps=60, latest_only=True)] * 4
    assert calls[4] == dict(steps=160, from_scratch=True)


# ------------------------------------------------------------ Ellis, chaos
def test_ellis_matches_jax():
    rng = np.random.RandomState(7)
    port = EllisScaler((4, 36), rescale_overhead=6.8, candidate_stride=2)
    ref = JEllisScaler((4, 36), rescale_overhead=6.8, candidate_stride=2)
    for _ in range(6):
        for comp in range(5):
            s = float(rng.choice([4, 8, 11, 14, 18, 21, 25]))
            t = 40.0 + 300.0 / s + rng.rand() * 5
            port.observe_component(comp, s, t)
            ref.observe_component(comp, s, t)
        port.refit()
        ref.refit()
        for _ in range(4):
            kw = dict(next_comp=int(rng.randint(0, 5)), n_components=5,
                      elapsed=float(rng.rand() * 100),
                      current_scaleout=int(rng.randint(4, 37)),
                      target_runtime=float(100 + rng.rand() * 300))
            assert port.recommend(**kw) == ref.recommend(**kw)
    assert port.predict_component(9, 12.0) == ref.predict_component(9, 12.0)


def test_chaos_injector_matches_jax():
    spec = dict(name="c", seed=3, nan_graphs_every=2, cache_corrupt_every=3,
                nan_fit_every=4)
    port = ChaosInjector(ChaosSpec(**spec), exp_seed=5)
    ref = JChaosInjector(JChaosSpec(**spec), exp_seed=5)
    for every in (0, 1, 2, 3, 7):
        assert [port._fires(every, r) for r in range(20)] == \
            [ref._fires(every, r) for r in range(20)]
    jtr, tr = _trainer_pair(seed=1)
    for run in range(8):
        jg = [_chain_graph(jgraph, k, seed=run * 3 + k) for k in range(3)]
        tg = [_chain_graph(graph, k, seed=run * 3 + k) for k in range(3)]
        jg, tg = ref.poison_graphs(jg, run), port.poison_graphs(tg, run)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.metrics, b.metrics)
            np.testing.assert_array_equal(a.runtime, b.runtime)
        jtr.extend_history(jg)
        tr.extend_history(tg)
        ref.after_fit(jtr, run)
        port.after_fit(tr, run)
        _assert_cache_equal(tr.cache, jtr.cache)
        assert tr.params_finite() == jtr.params_finite()
    assert (port.graphs_poisoned, port.cache_rows_corrupted,
            port.fits_poisoned) == (ref.graphs_poisoned,
                                    ref.cache_rows_corrupted,
                                    ref.fits_poisoned)
    assert port.fits_poisoned > 0 and port.cache_rows_corrupted > 0
    assert port.snapshot() == ref.snapshot()


# ------------------------------------------ K-Means run-5 scratch retrain
# The first Adam step at which the port's and the reference's scratch fit
# on this ring part (``tools/enel_picks_parity.py --jobs kmeans
# --fit-trace``): one f2 hidden unit's pre-activation at one node sits
# within float32 rounding of zero, and the leaky ReLU's slope there (1 or
# 0.1) decides that step's gradient.  The reference on the same ring with
# its slots in another order parts from itself at the same step by the same
# amount (``--routes ref ref-permuted``), so the steps after it are not
# held here.
KMEANS_SPLIT_STEP = 79


@pytest.fixture(scope="module")
def kmeans_run5_ring():
    """Snapshot of the reference's K-Means ring at its 5th adaptive run's
    scratch retrain, under ``chip_smoke.py``'s training protocol (10
    profiling runs, 5 Enel runs, fits without metric dropout)."""
    from repro.dataflow import runner as jrunner
    jex = jrunner.JobExperiment("kmeans", seed=0)
    fit = jex.trainer.fit_resident
    jex.trainer.fit_resident = \
        lambda **kw: fit(**dict(kw, metric_dropout=0.0))
    jex.profile()
    for _ in range(5):
        jex.adaptive_run("enel", inject_failures=False)
    assert jex.trainer.runs_seen == 5
    return jex.trainer.cache.snapshot()


def test_kmeans_scratch_fit_matches_jax_up_to_the_split(kmeans_run5_ring):
    """The port's guarded Adam steps against the reference's on the run-5
    ring (rebuilt on both sides from one snapshot), from the same
    ``init_enel`` parameters, every step up to the last before the split:
    losses and parameters within the reference's gradient tolerance."""
    jb, jw = jgraph.TrainingCache.from_snapshot(kmeans_run5_ring).full_batch()
    tb, tw = graph.TrainingCache.from_snapshot(kmeans_run5_ring,
                                               device="cpu").full_batch()
    np.testing.assert_array_equal(tw, jw)
    jp, tp = _params_pair(0)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jopt = (zeros, zeros, jnp.zeros((), jnp.int32))
    topt = (training.map_params(torch.zeros_like, tp),
            training.map_params(torch.zeros_like, tp),
            torch.zeros((), dtype=torch.int32))
    jw, tw = jnp.asarray(jw), torch.as_tensor(tw)
    for _ in range(1, KMEANS_SPLIT_STEP):
        jp, jopt, jl, jok = _JAX_ADAM_UPDATE(jp, jopt, jb, 5e-3, jw, False)
        tl, tok = training._adam_update(tp, topt, tb, 5e-3, tw)
        assert bool(tok) and bool(jok)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
        _assert_tree_close(tp, jp, atol=1e-4, rtol=1e-3)
    assert int(topt[2]) == int(jopt[2]) == KMEANS_SPLIT_STEP - 1
