"""The port's spans and counters on its serving path (``repro_torch.obs``,
``obs/spans.py``) and the benchmark's readers of them.

On the CPU, at smoke size: a span records only under a torch profiler; it
changes no number; one wave gives the tree of ``serve.*`` and ``model.*``
spans with their counters, each also a host op (``cpu_op``) of the
profiler's trace on the same clock; a train step's layers record their
forward and their recompute; the MoE's ``kept`` counter equals the
reference's dispatch sum; the three readers under ``bench/metrics`` read
a traced run of each cell and nothing else; ``ServeStats`` costs one
synchronize a wave.  The ``cuda``-marked test runs on the card (``python
-m pytest -m cuda tests/test_torch_spans.py``): no span is counted as a
device operation, and a prefill's ``model.*`` spans cover its device
time.  The reference is imported inside the test that compares with it,
so this file also loads where JAX is not installed.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import init_model, moe, prefill
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ARCHS = ["olmoe-1b-7b", "pixtral-12b"]
READERS = ("moe_us_per_row.serve", "head_us_per_row.serve",
           "moe_slot_fill.serve")
LENS = (5, 9, 7)
NEW = 3


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    with obs.obs_enabled(True):
        yield
    obs.reset()


def _model(arch):
    cfg = smoke_config(get_config(arch))
    return cfg, init_model(cfg, seed=3, device="cpu")


def _wave(cfg):
    reqs = [Request(prompt=np.arange(n) % 200 + 2, max_new_tokens=NEW)
            for n in LENS]
    extras = None
    if cfg.family == "vlm":
        g = torch.Generator().manual_seed(5)
        extras = {"patches": 0.1 * torch.randn(
            len(LENS), cfg.n_patches, cfg.d_model, generator=g)}
    return reqs, extras


def _serve(cfg, params, traced: bool):
    reqs, extras = _wave(cfg)
    eng = ServeEngine(cfg, params, max_len=40, device="cpu")
    if not traced:
        return eng.serve_wave(reqs, extras), reqs, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = eng.serve_wave(reqs, extras)
    return stats, reqs, prof


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["seq"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_profiler_no_record(arch):
    cfg, params = _model(arch)
    assert not obs.recording()
    assert obs.span("serve.wave") is obs.span("model.head")   # shared no-op
    _serve(cfg, params, traced=False)
    assert obs.span_records() == []


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_change_no_number(arch):
    """Served tokens and prefill logits are bit-equal with spans on and
    off."""
    cfg, params = _model(arch)
    _, off, _ = _serve(cfg, params, traced=False)
    _, on, _ = _serve(cfg, params, traced=True)
    assert [r.out_tokens for r in on] == [r.out_tokens for r in off]
    reqs, extras = _wave(cfg)
    batch = {"tokens": torch.tensor(np.stack([
        np.pad(r.prompt, (max(LENS) - len(r.prompt), 0)) for r in reqs]))}
    batch.update(extras or {})
    want, _ = prefill(params, cfg, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        got, _ = prefill(params, cfg, batch)
    assert obs.span_records()
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_wave_gives_the_span_tree(arch):
    cfg, params = _model(arch)
    stats, _, prof = _serve(cfg, params, traced=True)
    recs = obs.span_records()
    assert obs.SPANS.dropped == 0
    by_seq = {r["seq"]: r for r in recs}
    (wave,) = [r for r in recs if r["name"] == "serve.wave"]
    p, b = max(LENS), len(LENS)
    rows = b * (p + cfg.n_patches)
    assert wave["parent"] is None
    top = _children(recs, wave)
    assert [r["name"] for r in top] == \
        ["serve.prefill"] + ["serve.decode"] * stats.decode_steps
    assert top[0]["attrs"] == {"rows": rows}
    ffn = "model.moe" if cfg.n_experts else "model.ffn"
    for fwd in top:
        kids = _children(recs, fwd)
        assert [r["name"] for r in kids] == \
            ["model.embed"] + ["model.layer"] * cfg.n_layers + ["model.head"]
        for lay in kids[1:-1]:
            assert [r["name"] for r in _children(recs, lay)] == \
                ["model.attention", ffn]
    for r in recs:
        if r["name"] == "model.moe":
            assert set(r["attrs"]) == {"kept", "routed", "slots"}
        elif r is not top[0]:
            assert r["attrs"] == {}, r["name"]
        assert r["start_ns"] <= r["end_ns"]
        assert r["device_s"] == pytest.approx(
            (r["end_ns"] - r["start_ns"]) * 1e-9)       # the CPU's own
        if r["parent"] is not None:
            up = by_seq[r["parent"]]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                up["end_ns"]
    # the same spans are host ops of the profiler's trace, nested alike
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("serve.", "model."))]
    assert sorted(e.name() for e in events) == sorted(r["name"]
                                                      for r in recs)
    assert {e.activity_type() for e in events} == {"cpu_op"}
    iv = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in events), key=lambda x: (x[0], -x[1]))
    for a0, a1, _ in iv:                  # nested or disjoint, never crossed
        for b0, b1, _ in iv:
            assert b1 <= a0 or b0 >= a1 or (a0 <= b0 and b1 <= a1) or \
                (b0 <= a0 and a1 <= b1)


@pytest.mark.parametrize("arch", ARCHS)
def test_records_share_the_profilers_clock(arch):
    """A record's host start and end lie within 100 us of its profiler
    event's."""
    cfg, params = _model(arch)
    _, _, prof = _serve(cfg, params, traced=True)
    recs = obs.span_records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("serve.", "model."))]
    for name in {r["name"] for r in recs}:
        mine = sorted((r["start_ns"], r["end_ns"]) for r in recs
                      if r["name"] == name)
        theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                        for e in events if e.name() == name)
        assert len(mine) == len(theirs)
        for (a, b), (c, d) in zip(mine, theirs):
            assert abs(a - c) < 100_000 and abs(b - d) < 100_000, name


def test_train_mode_and_recompute_spans():
    """A train step under remat: each layer's span fires in the forward
    (before the head) and again in its recompute in the backward (after
    it)."""
    from repro_torch.models import apply_model
    cfg, params = _model("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, remat="full")
    for t in params["layers"][0]["moe"].values():
        t.requires_grad_(True)
    tokens = torch.tensor(np.arange(32).reshape(2, 16) % 200 + 2)
    with profile(activities=[ProfilerActivity.CPU]):
        logits, aux = apply_model(params, cfg, {"tokens": tokens})
        (logits.float().square().mean() + aux).backward()
    recs = obs.span_records()
    (head,) = [r for r in recs if r["name"] == "model.head"]
    layers = [r for r in recs if r["name"] == "model.layer"]
    assert len(layers) == 2 * cfg.n_layers
    assert sum(r["end_ns"] <= head["start_ns"] for r in layers) == \
        cfg.n_layers
    assert sum(r["start_ns"] >= head["end_ns"] for r in layers) == \
        cfg.n_layers


def _moe_cfgs(name, **changes):
    from repro.configs.base import ModelConfig
    cfg = dataclasses.replace(smoke_config(get_config(name)), **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name,changes", [
    ("jamba-v0.1-52b", {}),
    ("arctic-480b", {"moe_group": 16}),
    ("olmoe-1b-7b", {"moe_group": 32})])
def test_moe_counts_the_references_kept_pairs(name, changes, monkeypatch):
    """``kept`` equals the reference's ``dispatch.sum()`` on inputs that
    drop pairs past capacity; ``routed`` = G T K, ``slots`` = G E C."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as ref_moe
    cfg, rcfg = _moe_cfgs(name, **changes)
    rp = ref_moe.init_moe(jax.random.PRNGKey(4), rcfg)
    p = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    rng = np.random.RandomState(11)
    # one offset shared by every token skews the routing to a few experts
    x = (rng.randn(2, 64, cfg.d_model) + 3 * rng.randn(cfg.d_model)).astype(
        np.float32)
    seen = {}

    class _Jnp:                          # the reference's dispatch, caught
        def __getattr__(self, attr):
            return getattr(jnp, attr)

        @staticmethod
        def einsum(spec, *ops, **kw):
            if spec == "gtec,gtd->egcd":
                seen["dispatch"] = np.asarray(ops[0], np.float64)
            return jnp.einsum(spec, *ops, **kw)
    monkeypatch.setattr(ref_moe, "jnp", _Jnp())
    ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("model.moe"):
            moe.moe_ffn(p, cfg, torch.tensor(x))
    (rec,) = obs.span_records()
    t = min(64, cfg.moe_group)
    g = 2 * 64 // t
    c = moe.capacity(cfg, t)
    a = rec["attrs"]
    assert a["routed"] == g * t * cfg.top_k
    assert a["slots"] == g * cfg.n_experts * c
    assert a["kept"] == seen["dispatch"].sum()
    assert a["kept"] < a["routed"]                     # pairs were dropped


def _cell(workload, seed):
    from bench.core import harness
    from bench.tests import tiny
    bench, ctx = tiny.context(workload, seed=seed, trace=True)
    return harness.run_cell(ctx, bench)


def _readers():
    from bench.core import harness
    return {n: harness.module_at(harness.BENCH / "metrics" / f"{n}.py",
                                 "bench_metric_" + n.replace(".", "_"))
            for n in READERS}


@pytest.mark.parametrize("workload", ["olmoe-code", "pixtral-vqa"])
def test_readers_read_the_traced_stretch_only(workload, monkeypatch):
    """The three readers on a trace-on run of each cell: finite values
    (the MoE's only in the MoE cell), a fill in (0, 100]; None without a
    trace; the same values whether or not another run's records are in
    the ring."""
    from bench.drivers import serve_wave
    readers = _readers()
    recs = []
    real_run = serve_wave.run

    def keep(ctx, *a, **k):
        recs.append(real_run(ctx, *a, **k))
        return recs[-1]
    monkeypatch.setattr(serve_wave, "run", keep)
    res = _cell(workload, seed=2 ** 33 + 5)
    assert res["correct"]
    first = {n: r.read(recs[0]) for n, r in readers.items()}
    moe_cell = workload == "olmoe-code"
    for n, v in first.items():
        if "moe" in n and not moe_cell:
            assert v is None, n
            continue
        assert v is not None and math.isfinite(v) and v > 0, (n, v)
        assert res["metrics"][n]["value"] == v
    if moe_cell:
        assert 0 < first["moe_slot_fill.serve"] <= 100
    for r in readers.values():
        assert r.read(dict(recs[0], trace=None)) is None
        assert r.read({k: v for k, v in recs[0].items()
                       if k != "trace"}) is None
    last = max(r["seq"] for r in obs.span_records())
    _cell(workload, seed=2 ** 33 + 6)
    assert {n: r.read(recs[0]) for n, r in readers.items()} == first
    second = {n: r.read(recs[1]) for n, r in readers.items()}
    alone = obs.span_records()
    monkeypatch.setattr(obs, "span_records",
                        lambda: [r for r in alone if r["seq"] > last])
    assert {n: r.read(recs[1]) for n, r in readers.items()} == second


def test_a_wave_synchronizes_once(monkeypatch):
    """``prefill_s`` ends at the first tokens on the host; the only
    synchronize of a wave is the one that ends its decode."""
    cfg, params = _model("olmoe-1b-7b")
    calls = []
    monkeypatch.setattr(engine_mod, "_sync", lambda dev: calls.append(dev))
    stats, reqs, _ = _serve(cfg, params, traced=False)
    assert len(calls) == 1
    assert stats.prefill_s > 0 and stats.decode_s > 0
    assert stats.tokens_out == NEW * len(LENS) == \
        sum(len(r.out_tokens) for r in reqs)
    assert stats.decode_steps == NEW


@pytest.fixture
def card():
    """The CUDA card and nvcc, or a skip naming what is missing."""
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    try:
        build.find_nvcc()
    except RuntimeError as err:
        pytest.skip(f"needs nvcc: {err}")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_on_the_card_spans_are_no_device_work(card, arch):
    """Under the benchmark's tracer, at the configuration's widths cut to
    two layers: no span is among the device operations, and a prefill's
    ``model.*`` spans cover 90-100 % of its device seconds."""
    from bench.core.trace import traced
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              dtype="bfloat16", param_dtype="bfloat16")
    params = init_model(cfg, seed=1, device=card)
    plen, b = (1024, 8) if cfg.n_experts else (24, 8)
    rng = np.random.RandomState(2)
    extras = None
    if cfg.family == "vlm":
        extras = {"patches": 0.1 * torch.randn(
            b, cfg.n_patches, cfg.d_model, device=card,
            dtype=torch.bfloat16)}

    def wave():
        reqs = [Request(prompt=rng.randint(2, 1000, plen), max_new_tokens=3)
                for _ in range(b)]
        ServeEngine(cfg, params, max_len=plen + cfg.n_patches + 3,
                    device=card).serve_wave(reqs, extras)
    wave()                                               # warm-up
    out = {}
    with traced(out):
        wave()
    assert not [k for k in out["kernels"]
                if k[0].startswith(("serve.", "model."))]
    assert {n for n, _, _ in out["cpu"] if n.startswith("serve.")} == \
        {"serve.wave", "serve.prefill", "serve.decode"}
    recs = obs.span_records()
    (pre,) = [r for r in recs if r["name"] == "serve.prefill"]
    kids = sum(r["device_s"] for r in _children(recs, pre))
    assert 0.9 <= kids / pre["device_s"] <= 1.0, (kids, pre["device_s"])
