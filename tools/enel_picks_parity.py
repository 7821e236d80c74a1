"""Enel's picks, reference against port, run by run, on the CPU.

Both packages run ``JobExperiment`` on one job under ``chip_smoke.py``'s
training protocol (``run_training``): 10 profiling runs and the scratch fit,
6 adaptive Enel runs (the 5th retrains from scratch), one Enel run with
failures injected and one Ellis run.  The port gets the reference's
auto-encoder weights and initial parameters, and both fits run without
metric dropout (the reference draws its masks from ``jax.random``, which the
port cannot reproduce), as ``tests/test_torch_runner.py`` sets them up.

Every Enel decision's pick and per-candidate totals are kept on both sides.
A run's picks either all agree, or the first decision where they differ is
printed with its margin: over the candidates whose compliance (total <=
target) differs between the two, the largest distance of their totals from
the target, relative to it (where none does, the two picks' totals apart).
The runs after a differing pick start from other scale-outs and are compared
only as far as their picks go.  The last line is a JSON summary.

    PYTHONPATH=src python tools/enel_picks_parity.py [--jobs lr mpc gbt]

``--fit-trace`` runs the first job instead to the end of its 5th adaptive
run (whose cadence fit is the first scratch retrain after ``profile()``) and
replays that scratch fit one Adam step at a time from the reference's
``init_enel`` parameters on each side's own ring (``cache.full_batch()``):
for every step the loss on both sides and the leaf and element whose values
differ most, relative to the leaf's largest value.  At the first step where
that difference passes 1e-5 it prints the element's gradient on both sides,
its Adam moments before the step and, for a first-layer weight of f1 or f2
(the node-level MLPs), the pre-activations of its hidden unit and the
per-node terms of its gradient, recomputed in float64 from each side's own
forward values.  ``--routes ref ref-kernel`` replays the same fit through
the reference alone, its plain route against its Pallas kernel (interpret
mode); ``--routes ref ref-permuted`` against itself on the same ring with
its slots in a seeded order (``--perm-seed``): the same loss terms, whose
sums run in another order (``port-permuted`` likewise for the port).

    PYTHONPATH=src python tools/enel_picks_parity.py --jobs kmeans
        --fit-trace [--routes ref port] [--steps 128] [--perm-seed 2]

Needs JAX (the reference) and runs on the CPU; a job takes a few minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import model as jmodel  # noqa: E402
from repro.dataflow import runner as jrunner  # noqa: E402
from repro_torch.convert import enel_params_from_numpy  # noqa: E402
from repro_torch.dataflow import runner  # noqa: E402

PLAN = [("enel", False)] * 6 + [("enel", True), ("ellis", False)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _no_dropout(trainer):
    fit = trainer.fit_resident
    trainer.fit_resident = lambda **kw: fit(**dict(kw, metric_dropout=0.0))


def _keep(decisions, fn):
    """``fn`` (returning (pick, predicted, totals)) that also appends the
    triple to ``decisions``."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        decisions.append((int(out[0]), dict(out[2])))
        return out
    return wrapped


def margin(ref_totals, port_totals, ref_pick, port_pick, target):
    """How close a differing pick sits to a rounding flip, relative to the
    target (see the module docstring)."""
    flipped = [s for s in ref_totals if s in port_totals and
               (ref_totals[s] <= target) != (port_totals[s] <= target)]
    if flipped:
        return max(max(abs(ref_totals[s] - target),
                       abs(port_totals[s] - target))
                   for s in flipped) / abs(target)
    return abs(port_totals[port_pick] - port_totals[ref_pick]) / abs(target)


def make_pair(key: str, seed: int = 0):
    """(reference experiment, port experiment) in the same state, with the
    same auto-encoder weights and initial parameters, fits without metric
    dropout."""
    jex = jrunner.JobExperiment(key, seed=seed)
    ex = runner.JobExperiment(key, seed=seed, device="cpu",
                              ae_params=_np(jex.encoder.ae_params))
    init = _np(jmodel.init_enel(jax.random.PRNGKey(seed)))
    ex.trainer.init_params = enel_params_from_numpy(init, device="cpu")
    ex.trainer.params = enel_params_from_numpy(init, device="cpu")
    _no_dropout(jex.trainer)
    _no_dropout(ex.trainer)
    return jex, ex


def compare_job(key: str, seed: int = 0) -> dict:
    t0 = time.perf_counter()
    jex, ex = make_pair(key, seed)
    jdec, dec = [], []
    jex.enel.apply_decision = _keep(jdec, jex.enel.apply_decision)
    ex.enel.apply_decision = _keep(dec, ex.enel.apply_decision)
    jex.profile()
    ex.profile()
    out = {"job": key, "target": [float(jex.target), float(ex.target)],
           "runs": []}
    print(f"{key}: target reference {jex.target:.6f} s, port "
          f"{ex.target:.6f} s", flush=True)
    for method, inject in PLAN:
        n0, m0 = len(jdec), len(dec)
        jst = jex.adaptive_run(method, inject_failures=inject)
        st = ex.adaptive_run(method, inject_failures=inject)
        run = {"method": method, "failures": inject,
               "scaleouts": [jst.scaleouts, st.scaleouts],
               "runtime": [float(jst.runtime), float(st.runtime)],
               "decisions": [len(jdec) - n0, len(dec) - m0], "first_diff": None}
        worst = 0.0
        for d, ((jp, jt), (pp, pt)) in enumerate(zip(jdec[n0:], dec[m0:])):
            common = [s for s in jt if s in pt]
            worst = max([worst] + [abs(pt[s] - jt[s]) / abs(jt[s])
                                   for s in common if jt[s]])
            if jp != pp:
                mg = margin(jt, pt, jp, pp, jex.target)
                run["first_diff"] = {"decision": d, "reference": jp,
                                     "port": pp, "margin": mg,
                                     "reference_total": jt[jp],
                                     "port_total": pt[pp]}
                break
        run["totals_max_rel_diff"] = worst
        out["runs"].append(run)
        same = jst.scaleouts == st.scaleouts
        diff = run["first_diff"]
        print(f"  {method:5s} failures={inject!s:5s}: picks "
              f"{'agree' if same and diff is None else 'DIFFER'} "
              f"({run['decisions'][0]} / {run['decisions'][1]} decisions, "
              f"totals within {worst:.2g} relative); runtime reference "
              f"{jst.runtime:.2f} s, port {st.runtime:.2f} s"
              + ("" if diff is None else
                 f"; first at decision {diff['decision']}: reference "
                 f"{diff['reference']} ({diff['reference_total']:.6f} s), "
                 f"port {diff['port']} ({diff['port_total']:.6f} s), "
                 f"margin {diff['margin']:.3g} of the target"), flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ fit trace
JUMP = 1e-5          # relative parameter difference that counts as a split


def leaf_names(params) -> list:
    """Names of the parameter leaves in ``param_leaves`` order (sorted keys,
    layers in order), e.g. ``f2[0].w``; the reference's pytree flattens in
    the same order."""
    names = []
    for k in sorted(params):
        if isinstance(params[k], list):
            names += [f"{k}[{i}].{kk}" for i, layer in enumerate(params[k])
                      for kk in sorted(layer)]
        else:
            names.append(k)
    return names


def _leaves_np(tree) -> list:
    return [np.array(x, np.float32) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]


def _permuted(buffers, w, perm):
    """The ring's slots (and their weights) in the order ``perm``: the same
    loss terms, summed in another order."""
    if perm is None:
        return {k: np.asarray(v) for k, v in buffers.items()}, np.asarray(w)
    return {k: np.asarray(v)[perm] for k, v in buffers.items()}, \
        np.asarray(w)[perm]


class RefRoute:
    """The reference's guarded Adam step on its ring, one step per call
    (``use_kernel`` routes eqs. 6-7 through its Pallas kernel, interpret
    mode on the CPU; ``perm`` reorders the ring's slots)."""

    def __init__(self, trainer, init_np, use_kernel: bool = False,
                 perm=None, name: str = "ref"):
        import jax.numpy as jnp
        from repro.core import training as jtraining
        self.name = name
        self.perm = perm
        self.use_kernel = use_kernel
        self.lr = trainer.lr
        buffers, w = _permuted(*trainer.cache.full_batch(), perm)
        self.batch = {k: jnp.asarray(v) for k, v in buffers.items()}
        self.weights = jnp.asarray(w)
        self.params = jax.tree_util.tree_map(jnp.asarray, init_np)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, self.params)
        self.opt = (zeros, zeros, jnp.zeros((), jnp.int32))
        self._step = jax.jit(jtraining._adam_update, static_argnums=(3, 5))
        self._grad = jax.jit(jax.grad(
            lambda p, b, w: jtraining.enel_loss(p, b, w, use_kernel)[0]))

    def step(self) -> float:
        self.params, self.opt, loss, _ = self._step(
            self.params, self.opt, self.batch, self.lr, self.weights,
            self.use_kernel)
        return float(loss)

    def state_np(self):
        mu, nu, t = self.opt
        return (_leaves_np(self.params), _leaves_np(mu), _leaves_np(nu),
                int(t))

    def grads_np(self, params) -> list:
        return _leaves_np(self._grad(params, self.batch, self.weights))

    def forward_np(self, params) -> dict:
        out = jmodel.forward_stacked(params, self.batch, self.use_kernel)
        return {k: np.asarray(out[k])
                for k in ("overhead", "runtime", "metrics")}

    def params_at(self, leaves):
        import jax.numpy as jnp
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(self.params),
            [jnp.asarray(x) for x in leaves])

    def batch_np(self) -> dict:
        return {k: np.asarray(v) for k, v in self.batch.items()}, \
            np.asarray(self.weights)


class PortRoute:
    """The port's guarded Adam step (``core/training.py::_adam_update``,
    in place) on its ring, one step per call, on the CPU (``perm``
    reorders the ring's slots)."""

    def __init__(self, trainer, init_np, perm=None, name: str = "port"):
        import torch
        from repro_torch.core import training as ttraining
        self.name = name
        self.perm = perm
        self.torch, self.tt = torch, ttraining
        self.lr = trainer.lr
        buffers, w = _permuted(*trainer.cache.full_batch(), perm)
        self.batch = {k: torch.from_numpy(v.copy()) for k, v in buffers.items()}
        self.weights = torch.from_numpy(w.copy())
        self.params = enel_params_from_numpy(init_np, device="cpu")
        self.opt = (ttraining.map_params(torch.zeros_like, self.params),
                    ttraining.map_params(torch.zeros_like, self.params),
                    torch.zeros((), dtype=torch.int32))

    def step(self) -> float:
        loss, _ = self.tt._adam_update(self.params, self.opt, self.batch,
                                       self.lr, self.weights)
        return float(loss)

    def state_np(self):
        leaves = self.tt.param_leaves
        mu, nu, t = self.opt
        to = lambda ts: [x.detach().numpy().copy() for x in ts]
        return (to(leaves(self.params)), to(leaves(mu)), to(leaves(nu)),
                int(t))

    def params_at(self, leaves):
        params = self.tt.map_params(self.torch.clone, self.params)
        for t, x in zip(self.tt.param_leaves(params), leaves):
            t.copy_(self.torch.from_numpy(x))
        return params

    def grads_np(self, params) -> list:
        torch = self.torch
        leaves = self.tt.param_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            swap = dict(zip(map(id, leaves), live))
            loss, _ = self.tt.enel_loss(
                self.tt.map_params(lambda p: swap[id(p)], params),
                self.batch, self.weights)
            grads = torch.autograd.grad(loss, live)
        return [g.numpy().copy() for g in grads]

    def forward_np(self, params) -> dict:
        from repro_torch.core import model as tmodel
        with self.torch.no_grad():
            out = tmodel.forward_stacked(params, self.batch)
        return {k: out[k].numpy()
                for k in ("overhead", "runtime", "metrics")}

    def batch_np(self) -> dict:
        return {k: v.numpy() for k, v in self.batch.items()}, \
            self.weights.numpy()


def _node_grad_terms(route, leaves, names, leaf: str, idx) -> dict:
    """For a first-layer weight or bias of f1 / f2: the hidden unit's
    pre-activations over every node and the per-node terms of the element's
    gradient, in float64 from the route's own float32 forward values (the
    runtime and overhead losses are the only ones f1 and f2 feed)."""
    from repro_torch.core.training import HUBER_DELTA
    P = {n: leaves[i].astype(np.float64) for i, n in enumerate(names)}
    b, w = route.batch_np()
    fw = route.forward_np(route.params_at(leaves))
    leaky_d = lambda z: np.where(z >= 0, 1.0, 0.1)
    leaky = lambda z: np.where(z >= 0, z, 0.1 * z)
    svec = lambda s: np.stack([1 - 1 / np.maximum(s, 1e-6),
                               np.log(np.maximum(s, 1e-6)),
                               np.maximum(s, 1e-6)], -1)
    hub_d = lambda e: np.where(np.abs(e) <= HUBER_DELTA, e,
                               HUBER_DELTA * np.sign(e))
    ctx = b["context"].astype(np.float64)
    a_vec = svec(b["a_raw"].astype(np.float64))
    z_vec = svec(b["z_raw"].astype(np.float64))
    o_hat = fw["overhead"].astype(np.float64)
    m = np.where(b["metrics_valid"][..., None], b["metrics"],
                 fw["metrics"]).astype(np.float64)
    wb = w.astype(np.float64)[:, None]
    rt_mask = b["runtime_valid"] & b["mask"] & ~b["is_summary"]
    ov_mask = b["overhead_valid"] & b["mask"]
    d_rt = max((rt_mask * wb).sum(), 1.0)
    d_ov = max((ov_mask * wb).sum(), 1.0)
    f2_in = np.concatenate([ctx, m, z_vec, o_hat[..., None]], -1)
    pre2 = f2_in @ P["f2[0].w"] + P["f2[0].b"]
    f2_out = leaky(pre2) @ P["f2[1].w"][:, 0] + P["f2[1].b"][0]
    g_t = wb * rt_mask * hub_d(fw["runtime"] - b["runtime"]) / d_rt
    g_pre2 = (g_t / (1 + np.exp(-f2_out)))[..., None] * \
        P["f2[1].w"][:, 0] * leaky_d(pre2)
    if leaf.startswith("f2"):
        pre, inp, g_pre = pre2, f2_in, g_pre2
    else:
        f1_in = np.concatenate([ctx, m, a_vec, z_vec, b["r"][..., None]], -1)
        pre1 = f1_in @ P["f1[0].w"] + P["f1[0].b"]
        g_o = wb * ov_mask * hub_d(o_hat - b["overhead"]) / d_ov + \
            g_pre2 @ P["f2[0].w"][-1]
        pre, inp = pre1, f1_in
        g_pre = g_o[..., None] * P["f1[1].w"][:, 0] * leaky_d(pre1)
    j = idx[-1]
    col = np.ones_like(pre[..., 0]) if leaf.endswith(".b") \
        else inp[..., idx[0]]
    terms = col * g_pre[..., j]
    # back to the ring's slot order, so both routes' rows line up
    ring = slice(None) if route.perm is None else np.argsort(route.perm)
    return {"pre": pre[ring, :, j], "terms": terms[ring], "input": col[ring],
            "grad64": float(terms.sum())}


def fit_trace(jex, ex, routes=("ref", "port"), steps: int = 128,
              seed: int = 0, perm_seed: int = 2) -> dict:
    """Replay the ring's scratch fit on two routes step by step (see the
    module docstring)."""
    init_np = _np(jmodel.init_enel(jax.random.PRNGKey(seed)))
    perm = np.random.RandomState(perm_seed).permutation(
        jex.trainer.cache.capacity)
    make = {"ref": lambda: RefRoute(jex.trainer, init_np),
            "ref-kernel": lambda: RefRoute(jex.trainer, init_np, True,
                                           name="ref-kernel"),
            "ref-permuted": lambda: RefRoute(jex.trainer, init_np,
                                             perm=perm, name="ref-permuted"),
            "port": lambda: PortRoute(ex.trainer, init_np),
            "port-permuted": lambda: PortRoute(ex.trainer, init_np, perm,
                                               name="port-permuted")}
    a, b = (make[r]() for r in routes)
    names = leaf_names(init_np)
    out = {"routes": list(routes), "steps": [], "jump": None}
    print(f"fit trace: {a.name} vs {b.name}, {steps} steps, lr {a.lr}",
          flush=True)
    for k in range(1, steps + 1):
        before = (a.state_np(), b.state_np())
        la, lb = a.step(), b.step()
        pa, pb = a.state_np()[0], b.state_np()[0]
        rel = []
        for x, y in zip(pa, pb):
            d = np.abs(x - y)
            rel.append((float(d.max() / max(np.abs(x).max(), 1e-30)),
                        np.unravel_index(int(d.argmax()), d.shape)))
        li = int(np.argmax([r for r, _ in rel]))
        worst, el = rel[li]
        el = tuple(int(i) for i in el)
        row = {"step": k, "loss": [la, lb], "worst": worst,
               "leaf": names[li], "element": list(el),
               "values": [float(pa[li][el]), float(pb[li][el])]}
        out["steps"].append(row)
        print(f"  step {k:3d}: loss {la:.7g} / {lb:.7g}; worst "
              f"{names[li]}{list(el)} {worst:.3g} relative "
              f"({row['values'][0]:.6f} / {row['values'][1]:.6f})",
              flush=True)
        if out["jump"] is None and worst > JUMP:
            out["jump"] = _jump_detail(a, b, before, names, li, el, k)
    return out


def _jump_detail(a, b, before, names, li, el, k) -> dict:
    """The element's gradient, Adam moments and (f1/f2) pre-activations on
    both sides at the step where the parameters first split."""
    leaf = names[li]
    det = {"step": k, "leaf": leaf, "element": list(el)}
    print(f"  first split at step {k}: {leaf}{list(el)}", flush=True)
    side = {}
    for r, (p, mu, nu, t) in zip((a, b), before):
        g = r.grads_np(r.params_at(p))[li][el]
        side[r.name] = {"grad": float(g), "m": float(mu[li][el]),
                        "v": float(nu[li][el]), "t": t}
        print(f"    {r.name:10s} grad {g:.6e}  m {mu[li][el]:.6e}  "
              f"v {nu[li][el]:.6e}  (t {t})", flush=True)
    det["sides"] = side
    if leaf.startswith(("f1[0].", "f2[0].")):
        ta = _node_grad_terms(a, before[0][0], names, leaf, el)
        tb = _node_grad_terms(b, before[1][0], names, leaf, el)
        live = ta["terms"] != 0
        flips = np.flatnonzero((np.sign(ta["pre"]) != np.sign(tb["pre"]))
                               .ravel())
        order = np.argsort(np.minimum(np.abs(ta["pre"]),
                                      np.abs(tb["pre"])).ravel())[:6]
        print(f"    float64 gradient from each side's forward values: "
              f"{ta['grad64']:.6e} / {tb['grad64']:.6e}; pre-activation "
              f"sign flips at {len(flips)} of {ta['pre'].size} node slots",
              flush=True)
        shape = ta["pre"].shape
        rows = []
        for f in order:
            gi, ni = np.unravel_index(int(f), shape)
            rows.append({"graph": int(gi), "node": int(ni),
                         "pre": [float(ta["pre"][gi, ni]),
                                 float(tb["pre"][gi, ni])],
                         "input": float(ta["input"][gi, ni]),
                         "term": [float(ta["terms"][gi, ni]),
                                  float(tb["terms"][gi, ni])]})
            print(f"    graph {gi:2d} node {ni}: pre {ta['pre'][gi, ni]:+.6e}"
                  f" / {tb['pre'][gi, ni]:+.6e}  input "
                  f"{ta['input'][gi, ni]:.6g}  term "
                  f"{ta['terms'][gi, ni]:+.6e} / {tb['terms'][gi, ni]:+.6e}",
                  flush=True)
        big = np.argsort(-np.abs(ta["terms"]).ravel())[:4]
        print("    largest terms: " + ", ".join(
            f"{ta['terms'].ravel()[f]:+.3e}/{tb['terms'].ravel()[f]:+.3e}"
            for f in big) + f"; {int(live.sum())} nonzero", flush=True)
        det.update(nearest_zero=rows, sign_flips=int(len(flips)),
                   grad64=[ta["grad64"], tb["grad64"]],
                   nonzero_terms=int(live.sum()))
    return det


def run_to_scratch_fit(jex, ex, runs: int = 5) -> None:
    """``profile()`` and ``runs`` adaptive Enel runs on both sides; the
    last run's cadence fit is the scratch retrain whose ring is traced."""
    jex.profile()
    ex.profile()
    for r in range(runs):
        jst = jex.adaptive_run("enel", inject_failures=False)
        st = ex.adaptive_run("enel", inject_failures=False)
        print(f"  run {r + 1}: picks "
              f"{'agree' if jst.scaleouts == st.scaleouts else 'DIFFER'}",
              flush=True)
    assert jex.trainer.runs_seen % 5 == 0, "not at a scratch retrain"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", nargs="+", default=["lr", "mpc", "gbt"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fit-trace", action="store_true")
    ap.add_argument("--routes", nargs=2, default=["ref", "port"],
                    choices=["ref", "ref-kernel", "ref-permuted", "port",
                             "port-permuted"])
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--perm-seed", type=int, default=2)
    args = ap.parse_args()
    if args.fit_trace:
        jex, ex = make_pair(args.jobs[0], args.seed)
        run_to_scratch_fit(jex, ex)
        out = fit_trace(jex, ex, args.routes, args.steps, args.seed,
                        args.perm_seed)
        out["steps"] = out["steps"][-1:]
        print(json.dumps({"fit_trace": out}))
        return 0
    results = [compare_job(key, args.seed) for key in args.jobs]
    print(json.dumps({"picks_parity": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
