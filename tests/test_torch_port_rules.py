"""Rules of the PyTorch port: it stands alone, runs where it is told to, and
its kernel wrapper refuses what the kernel cannot take.

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             or m.startswith("jax"))
print(json.dumps({"pick": pick, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert 4 <= got["pick"] <= 36


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.convert import enel_params_from_numpy
    from repro_torch.core.model import init_enel
    from repro_torch.core.training import EnelTrainer
    from repro_torch.dataflow.context import ContextEncoder
    from repro_torch.dataflow.workloads import JOBS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: EnelTrainer(),
             lambda: ContextEncoder([JOBS["kmeans"]]),
             lambda: init_enel(torch.Generator()),
             lambda: enel_params_from_numpy({"attn_a": np.zeros(16)})]
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


def test_wrapper_refuses_mixed_devices_and_grad():
    """A mix of devices raises; so does an input that requires grad off
    the CPU (the meta device stands in for a card here)."""
    p = _params("cpu")
    x, adj, m, valid = _inputs("cpu")
    with pytest.raises(ValueError, match="several devices"):
        ops.graph_prop(p, x.to("meta"), adj, m, valid, levels=2)
    meta = {k: ([{kk: t.to("meta") for kk, t in l.items()} for l in v]
                if isinstance(v, list) else v.to("meta"))
            for k, v in p.items()}
    xm, adjm, mm, vm = (t.to("meta") for t in (x, adj, m, valid))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.graph_prop(meta, xm.requires_grad_(), adjm, mm, vm, levels=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.graph_prop(meta, xm.detach(), adjm, mm, vm, levels=2)


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
    p = _params(card)
    x, adj, m, valid = _inputs(card)
    with pytest.raises(ValueError, match="several devices"):
        ops.graph_prop(p, x, adj.cpu(), m, valid, levels=2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.graph_prop(p, x.clone().requires_grad_(), adj, m, valid,
                       levels=2)
