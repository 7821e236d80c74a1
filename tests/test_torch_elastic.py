"""The port's Enel-driven elastic trainer against the JAX reference on the
CPU.

Both trainers read stage times through their module's own ``time``, which
the tests replace with one scripted clock each (the same sequence), so the
graphs Enel learns from do not depend on the machine.  The port is given
the reference's auto-encoder and Enel weights (``convert``) and the
reference's context strings ("tpu v5e", ["jax", "xla"]), which is all that
``jax.random`` would otherwise make differ.  Graph arrays are held at 1e-6
(contexts) and exactly (the rest), Enel's parameters after the fine-tunes
at the reference's gradient tolerance (atol 1e-4, rtol 1e-3).  The
reference runs on one CPU device, so its DP choices are (1,); the port's
own run at (1, 2, 4) with a failure holds ``tests/test_multidevice.py``'s
gates.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.configs import TRAIN_4K, get_config, smoke_config
from repro_torch.core.graph import STACK_KEYS, summary_node
from repro_torch.train import elastic
from repro_torch.train.checkpoint import latest_step, restore_checkpoint

REF_PLATFORM, REF_SOFTWARE = "tpu v5e", ["jax", "xla"]
CTX_ATOL = 1e-6
ATOL, RTOL = 1e-4, 1e-3
SHAPE = dataclasses.replace(TRAIN_4K, seq_len=32, global_batch=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke configs' ops are small, and test
    processes sharing a host's cores slow one another down with full
    pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ScriptedClock:
    """A stand-in for the ``time`` module: ``time()`` advances by a fixed
    cycle of steps."""

    def __init__(self):
        self.calls, self.now = 0, 1000.0

    def time(self) -> float:
        self.calls += 1
        self.now += 0.01 * (1 + self.calls % 7)
        return self.now


def _np_tree(t):
    import jax
    return jax.tree_util.tree_map(np.asarray, t)


def _ecfg(mod, path, **kw):
    base = dict(target_runtime=1.0, n_components=3, steps_per_component=2,
                dp_choices=(1,), ckpt_dir=str(path), seed=0)
    return mod.ElasticConfig(**{**base, **kw})


@pytest.fixture
def ref_strings(monkeypatch):
    monkeypatch.setattr(elastic, "PLATFORM", REF_PLATFORM)
    monkeypatch.setattr(elastic, "SOFTWARE", REF_SOFTWARE)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference's and the port's trainers after one run each from the
    same weights under the same scripted clock."""
    from repro.configs.base import ModelConfig
    from repro.train import elastic as ref
    cfg = smoke_config(get_config("qwen3-0.6b"))
    rcfg = ModelConfig(**dataclasses.asdict(cfg))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref, "time", ScriptedClock())
        jtr = ref.ElasticTrainer(rcfg, SHAPE,
                                 _ecfg(ref, tmp_path_factory.mktemp("r")))
        ae, enel0 = _np_tree(jtr.encoder.ae), _np_tree(jtr.enel.params)
        jres = jtr.run()
        mp.setattr(elastic, "time", ScriptedClock())
        mp.setattr(elastic, "PLATFORM", REF_PLATFORM)
        mp.setattr(elastic, "SOFTWARE", REF_SOFTWARE)
        tr = elastic.ElasticTrainer(
            cfg, SHAPE, _ecfg(elastic, tmp_path_factory.mktemp("p")),
            device="cpu")
        tr.encoder.ae = convert.autoencoder_params_from_numpy(ae, "cpu")
        tr.encoder._cache.clear()
        tr.enel.init_params = convert.enel_params_from_numpy(enel0, "cpu")
        tr.enel.params = convert.enel_params_from_numpy(enel0, "cpu")
        tr.enel._reset_opt()
        res = tr.run()
    finally:
        mp.undo()
    return jtr, jres, tr, res


def _graphs_equal(got, want, what):
    assert got.names == want.names, what
    assert got.component_id == want.component_id, what
    for key in STACK_KEYS:
        a, b = getattr(got, key), np.asarray(getattr(want, key))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {key}"
        if key == "context":
            np.testing.assert_allclose(a, b, atol=CTX_ATOL, rtol=0,
                                       err_msg=f"{what} {key}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {key}")


def test_elastic_run_matches_reference(pair):
    """DP trace, steps, rescales and elapsed time equal; every component
    graph equal; Enel's parameters after the fine-tunes at atol 1e-4 /
    rtol 1e-3; the checkpoints hold every step's state."""
    jtr, jres, tr, res = pair
    assert res == jres
    assert [l.stage_times for l in tr.logs] == \
        [l.stage_times for l in jtr.logs]
    assert len(tr.graphs) == len(jtr.graphs) == 3
    for i, (g, jg) in enumerate(zip(tr.graphs, jtr.graphs)):
        _graphs_equal(g, jg, f"graph {i}")
    want = convert.enel_params_from_numpy(_np_tree(jtr.enel.params), "cpu")
    assert tr.enel.adam_steps == 2 * 32
    for (path, a), b in zip(tree.leaves_with_paths(tr.enel.params),
                            tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=path)
    assert len(tr.losses) == 6 and all(np.isfinite(tr.losses))
    assert latest_step(tr.ecfg.ckpt_dir) == 6
    saved, step, meta = restore_checkpoint(tr.ecfg.ckpt_dir, tr._state)
    assert step == 6 and meta == {"dp": 1}
    for a, b in zip(tree.leaves(saved), tree.leaves(tr._state)):
        assert torch.equal(a, b)


def test_context_matches_reference(pair, ref_strings):
    """``TrainContextEncoder.context`` on the reference's auto-encoder and
    context strings, for every stage and several DP degrees."""
    jtr, _, tr, _ = pair
    for stage in elastic.STAGES:
        for dp in (1, 2, 8):
            np.testing.assert_allclose(tr.encoder.context(stage, dp),
                                       jtr.encoder.context(stage, dp),
                                       atol=CTX_ATOL, rtol=0)


def test_component_and_future_graphs_match_reference(pair, ref_strings):
    """``_component_nodes`` on injected logs (a rescale, a stage of zero
    time) and ``_future_builder`` with and without predecessors, at equal
    and unequal scale-outs, through ``_log_graph``."""
    from repro.core.graph import summary_node as ref_summary
    from repro.train import elastic as ref
    jtr, _, tr, _ = pair
    logs = [(3, 4, 2.5, {"data-load": 0.25, "train-step": 2.0,
                         "checkpoint": 0.25}, None),
            (4, 2, 1.0, {"data-load": 0.5, "train-step": 0.5,
                         "checkpoint": 0.0}, 4),
            (5, 1, 0.0004, {"data-load": 0.0001, "train-step": 0.0002,
                            "checkpoint": 0.0001}, 2)]
    for comp, dp, rt, times, frm in logs:
        nodes = tr._component_nodes(elastic.ComponentLog(comp, dp, rt, times,
                                                         frm))
        jnodes = jtr._component_nodes(ref.ComponentLog(comp, dp, rt, times,
                                                       frm))
        p, jp = summary_node(nodes, f"P{comp}"), ref_summary(jnodes,
                                                             f"P{comp}")
        _graphs_equal(elastic._log_graph(nodes, [p], comp),
                      ref._log_graph(jnodes, [jp], comp), f"log {comp}")
        for a, z, preds in ((dp, dp, []), (dp, 2 * dp, [p]),
                            (4.0, 1.0, [p, p])):
            jpreds = [jp] * len(preds)
            _graphs_equal(tr._future_builder(comp + 1, a, z, preds),
                          jtr._future_builder(comp + 1, a, z, jpreds),
                          f"future {comp} a={a} z={z}")


def test_port_elastic_rescale_and_failure_recovery(tmp_path, monkeypatch):
    """The gates of ``tests/test_multidevice.py``'s elastic run at DP
    choices (1, 2, 4) with a worker-group loss at component 2: eight steps,
    at least one rescale, two DP degrees; each re-mesh restores the state
    it saved bit for bit, and the checkpoints record the DP degree."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    shape = dataclasses.replace(TRAIN_4K, seq_len=32, global_batch=8)
    ecfg = elastic.ElasticConfig(
        target_runtime=3600.0, n_components=4, steps_per_component=2,
        dp_choices=(1, 2, 4), ckpt_dir=str(tmp_path / "ck"),
        fail_at_component=2, seed=0)
    tr = elastic.ElasticTrainer(cfg, shape, ecfg, device="cpu")
    restores = []
    build = tr._build

    def checked_build(dp, restore_from=None):
        before = None if restore_from is None else \
            [t.clone() for t in tree.leaves(tr._state)]
        build(dp, restore_from)
        if before is not None:
            after = tree.leaves(tr._state)
            restores.append(all(torch.equal(a, b)
                                for a, b in zip(before, after)))

    monkeypatch.setattr(tr, "_build", checked_build)
    res = tr.run()
    assert res["final_step"] == 8, res
    assert res["n_rescales"] >= 1, res
    assert len(set(res["dp_trace"])) >= 2, res
    assert restores and all(restores)
    assert int(tr._state["opt"]["step"]) == 8
    _, step, meta = restore_checkpoint(ecfg.ckpt_dir, tr._state)
    assert step == 8 and meta == {"dp": tr.logs[-1].dp}
    for log in tr.logs:
        if log.failed:        # the loss at component 2 shrinks DP by a step
            assert log.comp_idx == 2 and log.rescaled_from > log.dp
    assert all(np.isfinite(tr.losses)) and len(tr.losses) == 8
