"""Rules of the PyTorch port: it stands alone, runs where it is told to, and
its kernel wrappers refuse what the kernels cannot take.

The tests marked ``cuda`` need an NVIDIA card and ``nvcc``; they skip
without them, naming what is missing, and run on a machine with a card via
``python -m pytest -m cuda tests/test_torch_port_rules.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.graph_prop import ops

SRC = Path(__file__).resolve().parents[1] / "src"

_ISOLATION_SCRIPT = r"""
import importlib, json, pkgutil, sys
import numpy as np
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.core.graph import build_graph, NodeAttrs
from repro_torch.core.scaling import EnelScaler
from repro_torch.core.training import EnelTrainer
ctx = np.linspace(-1, 1, 24, dtype=np.float32)
def builder(k, a, z, preds):
    nodes = [NodeAttrs(f"s{i}", ctx, None, a if i == 0 else z, z)
             for i in range(2)]
    return build_graph(nodes + preds, [(0, 1)], k)
sc = EnelScaler(EnelTrainer(device="cpu"), (4, 36), candidate_stride=8)
pick = sc.recommend(graph_builder=builder, next_comp=1, n_components=3,
                    elapsed=1.0, current_scaleout=8, target_runtime=5.0)[0]
from repro_torch import obs
from repro_torch.core.service import DecisionService
req = sc.prepare_request(graph_builder=builder, next_comp=1, n_components=3,
                         elapsed=1.0, current_scaleout=8, target_runtime=5.0)
obs.recorder().clear()
with obs.obs_enabled(True):
    svc_pick = DecisionService().decide([req])[0].scaleout
spans = obs.recorder().span_counts()
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import init_model
from repro_torch.serve.engine import Request, ServeEngine
cfg = smoke_config(get_config("gemma2-2b"))
eng = ServeEngine(cfg, init_model(cfg, device="cpu"), max_len=32,
                  device="cpu")
req = Request(prompt=np.arange(6) + 2, max_new_tokens=3)
eng.serve_wave([req])
xcfg = smoke_config(get_config("xlstm-350m"))
xreq = Request(prompt=np.arange(7) + 2, max_new_tokens=3)
ServeEngine(xcfg, init_model(xcfg, device="cpu"), max_len=32,
            device="cpu").serve_wave([xreq])
jcfg = smoke_config(get_config("jamba-v0.1-52b"))
jreq = Request(prompt=np.arange(5) + 2, max_new_tokens=3)
ServeEngine(jcfg, init_model(jcfg, device="cpu"), max_len=32,
            device="cpu").serve_wave([jreq])
wcfg = smoke_config(get_config("whisper-medium"))
wreq = Request(prompt=np.arange(5) + 2, max_new_tokens=3)
frames = np.full((1, wcfg.enc_frames, wcfg.d_model), 0.1, np.float32)
ServeEngine(wcfg, init_model(wcfg, device="cpu"), max_len=32,
            device="cpu").serve_wave([wreq], {"frames": frames})
pcfg = smoke_config(get_config("pixtral-12b"))
preq = Request(prompt=np.arange(5) + 2, max_new_tokens=3)
patches = np.full((1, pcfg.n_patches, pcfg.d_model), 0.1, np.float32)
ServeEngine(pcfg, init_model(pcfg, device="cpu"), max_len=32,
            device="cpu").serve_wave([preq], {"patches": patches})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             or m.startswith("jax"))
print(json.dumps({"pick": pick, "svc_pick": svc_pick, "spans": spans,
                  "tokens": req.out_tokens,
                  "xlstm_tokens": xreq.out_tokens,
                  "jamba_tokens": jreq.out_tokens,
                  "whisper_tokens": wreq.out_tokens,
                  "pixtral_tokens": preq.out_tokens, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert 4 <= got["pick"] <= 36
    assert got["svc_pick"] == got["pick"]
    assert got["spans"] == {"decision.dispatch": 1}
    assert len(got["tokens"]) == 3
    assert len(got["xlstm_tokens"]) == 3
    assert len(got["jamba_tokens"]) == 3
    assert len(got["whisper_tokens"]) == 3
    assert len(got["pixtral_tokens"]) == 3


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.convert import enel_params_from_numpy
    from repro_torch.core.graph import TrainingCache, empty_graph
    from repro_torch.core.model import init_enel
    from repro_torch.core.service import DecisionService
    from repro_torch.core.training import EnelTrainer
    from repro_torch.dataflow.context import ContextEncoder
    from repro_torch.dataflow.runner import JobExperiment
    from repro_torch.dataflow.workloads import JOBS
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
    from repro_torch.launch.quickstart import main as quickstart_main
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import init_cache, init_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sim import evaluate
    from repro_torch.sim.engine import BatchedClusterSim
    cfg = smoke_config(get_config("qwen3-0.6b"))
    cpu_params = init_model(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: init_model(cfg),
             lambda: init_cache(cfg, 1, 8),
             lambda: ServeEngine(cfg, cpu_params),
             lambda: lm_params_from_numpy({"embed": np.zeros((4, 2)),
                                           "groups": {}}, cfg),
             lambda: lm_cache_from_numpy({"groups": {}}, cfg),
             lambda: serve_main(["--arch", "qwen3-0.6b", "--smoke"]),
             lambda: serve_main(["--arch", "xlstm-350m", "--smoke"]),
             lambda: serve_main(["--arch", "jamba-v0.1-52b", "--smoke"]),
             lambda: serve_main(["--arch", "whisper-medium", "--smoke"]),
             lambda: serve_main(["--arch", "pixtral-12b", "--smoke"]),
             lambda: quickstart_main(["--arch", "whisper-medium"]),
             lambda: EnelTrainer(),
             lambda: ContextEncoder([JOBS["kmeans"]]),
             lambda: init_enel(torch.Generator()),
             lambda: enel_params_from_numpy({"attn_a": np.zeros(16)}),
             lambda: TrainingCache(8),
             lambda: JobExperiment("kmeans"),
             lambda: JobExperiment("kmeans", service=DecisionService()),
             lambda: EnelTrainer(cache_capacity=8).fit([empty_graph()]),
             lambda: BatchedClusterSim(),
             lambda: JobExperiment("kmeans", engine="batched"),
             lambda: evaluate.run_scenario_campaign("baseline"),
             lambda: evaluate.run_scenario_campaign("multi_tenant"),
             lambda: evaluate.run_chaos_campaign("chaos_crashes"),
             lambda: evaluate.chaos_trace_identity(),
             lambda: evaluate.run_transfer_cell("baseline", 1.0,
                                                "node_failure", 1.6,
                                                "kmeans"),
             lambda: evaluate.run_transfer_cells()]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _inputs(device, b=3, n=8, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(b, n, ops.X_DIM).astype(np.float32),
                     device=device)
    adj = torch.tensor(np.tril(rng.rand(b, n, n) < 0.4, -1), device=device)
    m = torch.tensor(rng.rand(b, n, ops.N_METRICS).astype(np.float32),
                     device=device)
    valid = torch.tensor(rng.rand(b, n) < 0.4, device=device)
    return x, adj, m, valid


def _params(device):
    from repro_torch.core.model import init_enel
    return init_enel(torch.Generator().manual_seed(0), device=device)


def _cotangents(b, n, device, seed=1):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.randn(b, n, n).astype(np.float32), device=device),
            torch.tensor(rng.randn(b, n, ops.N_METRICS).astype(np.float32),
                         device=device))


def _grad_inputs(p, x, m):
    """Copies of the weights, x and m_obs that require grad."""
    ws = [w.clone().requires_grad_(True) for w in ops._weights(p)]
    return (ws, x.clone().requires_grad_(True),
            m.clone().requires_grad_(True))


def test_wrapper_refuses_mixed_devices_and_grad():
    """A mix of devices raises, and so does a device that is neither the CPU
    nor a card (the meta device stands in for one here), with or without
    grad.  On the CPU an input that requires grad goes through autograd of
    the plain version: grads equal ``graph_prop_vjp_plain``, no launch."""
    p = _params("cpu")
    x, adj, m, valid = _inputs("cpu")
    with pytest.raises(ValueError, match="several devices"):
        ops.graph_prop(p, x.to("meta"), adj, m, valid, levels=2)
    meta = {k: ([{kk: t.to("meta") for kk, t in l.items()} for l in v]
                if isinstance(v, list) else v.to("meta"))
            for k, v in p.items()}
    xm, adjm, mm, vm = (t.to("meta") for t in (x, adj, m, valid))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.graph_prop(meta, xm.requires_grad_(), adjm, mm, vm, levels=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.graph_prop(meta, xm.detach(), adjm, mm, vm, levels=2)
    ws, xg, mg = _grad_inputs(p, x, m)
    before = (ops.LAUNCHES, ops.LAUNCHES_BWD)
    e, mh = ops.graph_prop(ops._params(ws), xg, adj, mg, valid, levels=2)
    g_e, g_m = _cotangents(*x.shape[:2], "cpu")
    got = torch.autograd.grad((e, mh), [xg, mg] + ws, (g_e, g_m))
    ref = ops.graph_prop_vjp_plain(p, x, adj, m, valid, g_e, g_m, levels=2)
    assert (ops.LAUNCHES, ops.LAUNCHES_BWD) == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,levels", [(4, 7, 1), (8, 1, 3), (16, 357, 3),
                                        (16, 7, 8)])
def test_kernel_matches_plain_on_card(card, n, b, levels):
    p = _params(card)
    x, adj, m, valid = _inputs(card, b=b, n=n, seed=n + b)
    launches = ops.LAUNCHES
    e, mh = ops.graph_prop(p, x, adj, m, valid, levels=levels)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == launches + 1
    pe, pm = ops.graph_prop_plain(p, x, adj, m, valid, levels=levels)
    torch.testing.assert_close(e, pe, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mh, pm, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_wrapper_refuses_mix_and_grad_on_card(card):
    """On the card a mix of devices raises, with or without grad; an input
    that requires grad goes through the autograd route: one forward and
    one backward launch, grads equal to ``graph_prop_vjp_plain``."""
    p = _params(card)
    x, adj, m, valid = _inputs(card)
    with pytest.raises(ValueError, match="several devices"):
        ops.graph_prop(p, x, adj.cpu(), m, valid, levels=2)
    ws, xg, mg = _grad_inputs(p, x, m)
    with pytest.raises(ValueError, match="several devices"):
        ops.graph_prop(ops._params(ws), xg, adj.cpu(), mg, valid, levels=2)
    before = (ops.LAUNCHES, ops.LAUNCHES_BWD)
    e, mh = ops.graph_prop(ops._params(ws), xg, adj, mg, valid, levels=2)
    g_e, g_m = _cotangents(*x.shape[:2], card)
    got = torch.autograd.grad((e, mh), [xg, mg] + ws, (g_e, g_m))
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    ref = ops.graph_prop_vjp_plain(p, x, adj, m, valid, g_e, g_m, levels=2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,levels", [(4, 7, 1), (8, 96, 8), (16, 1, 3),
                                        (16, 7, 8)])
def test_bwd_kernel_matches_plain_vjp_on_card(card, n, b, levels):
    """The backward kernel against the plain VJP (the reference's gradient
    tolerance), and two launches on the same inputs agree bit for bit."""
    p = _params(card)
    x, adj, m, valid = _inputs(card, b=b, n=n, seed=n + b)
    g_e, g_m = _cotangents(b, n, card, seed=levels)
    launches = ops.LAUNCHES_BWD
    got = ops._launch_bwd(x, adj, m, valid, ops._weights(p), g_e, g_m, levels)
    again = ops._launch_bwd(x, adj, m, valid, ops._weights(p), g_e, g_m,
                            levels)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BWD == launches + 2
    ref = ops.graph_prop_vjp_plain(p, x, adj, m, valid, g_e, g_m,
                                   levels=levels)
    for g, g2, r in zip(got, again, ref):
        assert torch.equal(g, g2)
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
def test_fit_step_on_card_matches_cpu(card):
    """One guarded Adam step through both kernels on the card against the
    same step on the CPU route, from one state (the reference's fit
    tolerance)."""
    from repro_torch.core import training
    rng = np.random.RandomState(3)
    b, n = 16, 8
    mask = rng.rand(b, n) < 0.8
    mask[:, 0] = True
    stacked = {
        "context": np.tanh(rng.randn(b, n, 24)).astype(np.float32),
        "metrics": rng.rand(b, n, 5).astype(np.float32),
        "metrics_valid": (rng.rand(b, n) < 0.5) & mask,
        "a_raw": rng.uniform(1, 36, (b, n)).astype(np.float32),
        "z_raw": rng.uniform(1, 36, (b, n)).astype(np.float32),
        "r": rng.uniform(0.5, 1.0, (b, n)).astype(np.float32),
        "runtime": rng.uniform(1, 30, (b, n)).astype(np.float32),
        "runtime_valid": (rng.rand(b, n) < 0.7) & mask,
        "overhead": rng.uniform(0, 3, (b, n)).astype(np.float32),
        "overhead_valid": (rng.rand(b, n) < 0.3) & mask,
        "adj": np.tril(rng.rand(b, n, n) < 0.3, -1),
        "mask": mask,
        "is_summary": (rng.rand(b, n) < 0.2) & mask,
    }
    cpu = training.EnelTrainer(seed=0, device="cpu")
    cpu_batch = {k: torch.tensor(v) for k, v in stacked.items()}
    for _ in range(4):                   # leave the fresh Adam state
        training._adam_update(cpu.params, cpu.opt, cpu_batch, cpu.lr)
    move = lambda t: t.to(card)
    params = training.map_params(move, cpu.params)
    opt = (training.map_params(move, cpu.opt[0]),
           training.map_params(move, cpu.opt[1]), cpu.opt[2].to(card))
    before = (ops.LAUNCHES, ops.LAUNCHES_BWD)
    loss, ok = training._adam_update(
        params, opt, {k: v.to(card) for k, v in cpu_batch.items()}, cpu.lr)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    c_loss, c_ok = training._adam_update(cpu.params, cpu.opt, cpu_batch,
                                         cpu.lr)
    assert bool(ok) and bool(c_ok)
    torch.testing.assert_close(loss.cpu(), c_loss, atol=0, rtol=1e-5)
    for a, c in zip(training.param_leaves(params),
                    training.param_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), c, atol=1e-5, rtol=1e-4)
