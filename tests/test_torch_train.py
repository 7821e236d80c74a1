"""The port's LM training slice against the JAX reference on the CPU: the
token pipeline, AdamW, the loss, train steps, parameter counts,
checkpoints, the straggler detector, the training launcher, and gradients
through the three LM kernel wrappers.

Inputs come from numpy seeds; a train state comes from the reference's
``init_train_state`` through ``convert.train_state_from_numpy``, so both
packages start from one state.  Train steps run smoke configs in float32:
losses at 1e-5, parameters and moments at the reference's gradient
tolerance (atol 1e-4, rtol 1e-3, ``tests/test_fit_fast_path.py:83``).  The
reference is imported inside fixtures and tests: the card's machine has
no JAX, and the ``cuda`` tests at the end run there with ``python -m pytest
-m cuda tests/test_torch_train.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import (TRAIN_4K, get_config, list_archs,
                                 smoke_config)
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                       global_batch, sample_tokens)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.mlstm_chunk import ops as ml
from repro_torch.models import active_param_count, param_count
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, lr_at)
from repro_torch.train.stragglers import StragglerConfig, StragglerDetector
from repro_torch.train.train import (batch_to_device, loss_fn,
                                     make_eval_step, make_train_step)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device (xpu): the wrappers refuse
    any device but the CPU, a card and meta, which takes the card's route
    without launching."""

    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_Elsewhere)


LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-4, 1e-3          # the reference's gradient tolerance
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
SHAPE = dataclasses.replace(TRAIN_4K, seq_len=32, global_batch=4)
STEPS = 3


def _np_tree(t):
    import jax
    return jax.tree_util.tree_map(np.asarray, t)


def _ref_cfg(cfg):
    from repro.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


def _cfg(name):
    """A smoke config; "gemma2-2b-window" narrows gemma2's window to 5 so
    that it clips inside the test's sequences (softcaps as published)."""
    if name == "gemma2-2b-window":
        return dataclasses.replace(smoke_config(get_config("gemma2-2b")),
                                   sliding_window=5)
    return smoke_config(get_config(name))


def _batches(cfg, n=STEPS, shape=SHAPE, seed=3):
    return [global_batch(DataConfig(seed=seed), cfg, shape, i)
            for i in range(n)]


def _close_tree(port, ref, what, atol=ATOL, rtol=RTOL):
    pl, rl = tree.leaves_with_paths(port), tree.leaves_with_paths(ref)
    assert [p for p, _ in pl] == [p for p, _ in rl], what
    for (path, a), (_, b) in zip(pl, rl):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}/{path}"
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{what}/{path}")


def _equal_tree(a, b, what):
    la, lb = tree.leaves_with_paths(a), tree.leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}/{path}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke configs' ops are small, and test
    processes sharing a host's cores slow one another down with full
    pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ pipeline
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium",
                                  "pixtral-12b"])
def test_pipeline_batches_equal_reference_at_any_dp(arch):
    """Every shard at dp_size 1, 2 and 4, the audio frames and vlm patches
    included, byte for byte; the shards concatenate to the full batch."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import smoke_config as ref_smoke
    from repro.data import pipeline as ref
    cfg = smoke_config(get_config(arch))
    rcfg = ref_smoke(ref_get_config(arch))
    shape = dataclasses.replace(TRAIN_4K, global_batch=8)
    full = None
    for dp_size in (1, 2, 4):
        shards = []
        for rank in range(dp_size):
            got = global_batch(DataConfig(seed=7), cfg, shape, 3,
                               dp_rank=rank, dp_size=dp_size, seq_len=64)
            want = ref.global_batch(ref.DataConfig(seed=7), rcfg, shape, 3,
                                    dp_rank=rank, dp_size=dp_size,
                                    seq_len=64)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].tobytes() == want[k].tobytes(), (k, rank)
            shards.append(got)
        tokens = np.concatenate([s["tokens"] for s in shards])
        full = tokens if full is None else full
        np.testing.assert_array_equal(tokens, full)


def test_pipeline_targets_shifted_and_prefetch_in_order():
    mcfg = smoke_config(get_config("qwen3-0.6b"))
    seq = sample_tokens(DataConfig(seed=0), mcfg, step=0, sample=0,
                        seq_len=32)
    b = global_batch(DataConfig(seed=0), mcfg, TRAIN_4K, step=0,
                     dp_size=TRAIN_4K.global_batch, seq_len=32)
    np.testing.assert_array_equal(b["tokens"][0], seq[:-1])
    np.testing.assert_array_equal(b["targets"][0], seq[1:])
    assert b["tokens"].max() < mcfg.raw_vocab_size
    loader = PrefetchLoader(DataConfig(seed=1), mcfg, SHAPE, start_step=2,
                            seq_len=16)
    try:
        for want_step in (2, 3, 4):
            step, got = next(loader)
            want = global_batch(DataConfig(seed=1), mcfg, SHAPE, want_step,
                                seq_len=16)
            assert step == want_step
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    finally:
        loader.close()


# ----------------------------------------------------------------- optimizer
def test_lr_schedule_matches_reference():
    import jax.numpy as jnp
    from repro.train import optimizer as ref
    for opt in (AdamWConfig(), AdamWConfig(lr=1.0, warmup_steps=10,
                                           total_steps=100),
                AdamWConfig(warmup_steps=0, total_steps=1)):
        ropt = ref.AdamWConfig(*opt)
        got = [float(lr_at(opt, s)) for s in range(0, 130)]
        want = [float(ref.lr_at(ropt, jnp.int32(s))) for s in range(0, 130)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.1, 100.0])    # 100: clipped
def test_adamw_update_matches_reference(opt_dtype, grad_scale):
    """A mixed tree (float32 and bfloat16 leaves, a vector without weight
    decay) over three updates: params, moments, step and metrics against
    the reference at 1e-6 (bfloat16 values at one bf16 step of rounding)."""
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as ref
    rng = np.random.RandomState(0)
    p_np = {"a": rng.randn(4, 3), "b": [rng.randn(5), rng.randn(2, 3)],
            "c": {"d": rng.randn(3, 2, 2)}}
    bf = {"b/1"}                                   # a bfloat16 parameter

    def to_port(path, x):
        t = torch.tensor(np.asarray(x, np.float32))
        return t.to(torch.bfloat16) if path in bf else t

    def to_ref(path, x):
        a = jnp.asarray(np.asarray(x, np.float32))
        return a.astype(jnp.bfloat16) if path in bf else a

    params = tree.map_with_paths(to_port, p_np)
    rparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure({"a": 0, "b": [0, 0], "c": {"d": 0}}),
        [to_ref(p, x) for p, x in tree.leaves_with_paths(p_np)])
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    ropt = ref.AdamWConfig(*opt)
    state = init_opt_state(params, opt_dtype)
    rstate = ref.init_opt_state(rparams, opt_dtype)
    for _ in range(3):
        g_np = tree.tree_map(lambda x: rng.randn(*np.shape(x)) * grad_scale,
                             p_np)
        grads = tree.map_with_paths(to_port, g_np)
        rgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(rparams),
            [to_ref(p, x) for p, x in tree.leaves_with_paths(g_np)])
        params, state, m = adamw_update(params, grads, state, opt)
        rparams, rstate, rm = ref.adamw_update(rparams, rgrads, rstate, ropt)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(state["step"]) == int(rstate["step"])
        for got, want, what in ((params, rparams, "params"),
                                (state["mu"], rstate["mu"], "mu"),
                                (state["nu"], rstate["nu"], "nu")):
            for (path, a), b in zip(tree.leaves_with_paths(got),
                                    jax.tree_util.tree_leaves(want)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype), path
                b = np.asarray(b.astype(jnp.float32))
                bf16 = a.dtype == torch.bfloat16
                np.testing.assert_allclose(
                    a.float().numpy(), b, atol=1e-6,
                    rtol=2 ** -8 if bf16 else 1e-6,
                    err_msg=f"{what}/{path}")


def test_adamw_minimizes_quadratic():
    opt = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      total_steps=1000, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params, "float32")
    for _ in range(200):
        adamw_update(params, {"w": 2 * params["w"]}, state, opt)
    assert float(params["w"].abs().max()) < 1e-2


def test_lr_schedule_shape():
    opt = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_at(opt, 0)) < 0.2
    np.testing.assert_allclose(float(lr_at(opt, 9)), 1.0, atol=0.01)
    assert abs(float(lr_at(opt, 100)) - 0.1) < 0.01


def test_grad_clipping_bounds_update():
    opt = AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params, "float32")
    _, _, m = adamw_update(params, {"w": torch.full((4,), 1e6)}, state, opt)
    assert float(m["grad_norm"]) > 1e5     # reported raw
    assert float(params["w"].abs().max()) <= 1.01e-3


def test_no_weight_decay_on_vectors():
    opt = AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=1)
    params = {"norm": torch.ones(4), "mat": torch.ones((4, 4))}
    state = init_opt_state(params, "float32")
    zeros = {"norm": torch.zeros(4), "mat": torch.zeros((4, 4))}
    adamw_update(params, zeros, state, opt)
    np.testing.assert_allclose(params["norm"].numpy(), 1.0)   # untouched
    assert float(params["mat"].max()) < 1.0                   # decayed


# ---------------------------------------------------------------------- loss
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_loss_masks_invalid_targets_like_reference(arch):
    """Targets outside [0, raw_vocab_size) are masked out of the mean; the
    MoE config adds its aux term (``AUX_LOSS_WEIGHT``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import init_model as ref_init
    from repro.train.train import loss_fn as ref_loss
    cfg = smoke_config(get_config(arch))
    rcfg = _ref_cfg(cfg)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = lm_params_from_numpy(_np_tree(rparams), cfg, device="cpu")
    rng = np.random.RandomState(1)
    b, s = 2, 8
    tokens = rng.randint(0, cfg.raw_vocab_size, (b, s))
    targets = np.where(np.arange(s) < 4, tokens, -1)
    targets[1, 0] = cfg.raw_vocab_size + 2            # out of the raw vocab
    batch = {"tokens": tokens, "targets": targets}
    loss, parts = loss_fn(params, cfg, batch_to_device(batch, "cpu"))
    rloss, rparts = ref_loss(rparams, rcfg,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(parts["tokens"]) == float(rparts["tokens"]) == b * 4 - 1
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k]), float(rparts[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    assert (float(parts["aux"]) > 0) == bool(cfg.n_experts)
    ev = make_eval_step(cfg)(params, batch_to_device(batch, "cpu"))
    assert float(ev["loss"]) == float(loss)


# --------------------------------------------------------------- train steps
TRAIN_ARCHS = ["qwen3-0.6b", "gemma2-2b-window", "xlstm-350m",
               "jamba-v0.1-52b", "whisper-medium", "pixtral-12b"]


@pytest.fixture(scope="module", params=TRAIN_ARCHS)
def ref_run(request):
    """(cfg, the reference's initial state as numpy, its batches, its
    states as numpy and losses after each of STEPS jitted steps)."""
    import jax
    from repro.train.train import init_train_state as ref_init_state
    from repro.train.train import make_train_step as ref_step
    from repro.train.optimizer import AdamWConfig as RefOpt
    cfg = _cfg(request.param)
    rcfg = _ref_cfg(cfg)
    state = ref_init_state(jax.random.PRNGKey(0), rcfg, RefOpt(*OPT))
    init = _np_tree(state)
    batches = _batches(cfg)
    step = jax.jit(ref_step(rcfg, RefOpt(*OPT)))
    states, losses = [], []
    for b in batches:
        state, m = step(state, b)
        states.append(_np_tree(state))
        losses.append(float(m["loss"]))
    return cfg, init, batches, states, losses


def _port_run(cfg, init, batches, grad_accum=1):
    """The port's steps chained from its own state: (state, loss, grad norm)
    after each."""
    state = train_state_from_numpy(init, cfg, device="cpu")
    step = make_train_step(cfg, OPT, grad_accum)
    out = []
    for b in batches:
        state, m = step(state, batch_to_device(b, "cpu"))
        out.append((tree.tree_map(torch.clone, state), float(m["loss"]),
                    float(m["grad_norm"])))
    return out


def _check_steps(cfg, init, batches, states, losses, grad_accum=1):
    """Each port step from the reference's state before it, against the
    reference's state after it: the loss at 1e-5; both moments at atol 1e-4
    / rtol 1e-3; the parameters at atol 1e-4 / rtol 1e-3 wherever the
    reference's clipped gradient is at least 100 x Adam's eps.

    Below that, Adam's normalised step g / (|g| + eps) turns a float32
    summation-order difference of the gradient into a different step (an
    xLSTM input-gate bias has |g| ~ 3e-8 there, its leaf pure rounding
    noise): there each package moves the element by at most lr (1 + wd
    |p|), so the two may differ by twice that.  Steps are compared one at a
    time, each from the reference's state, since such an element changes
    the next step's gradients (xLSTM's exponential gates amplify it)."""
    step = make_train_step(cfg, OPT, grad_accum)
    prev = init
    for i, (b, want, rloss) in enumerate(zip(batches, states, losses)):
        state = train_state_from_numpy(prev, cfg, device="cpu")
        mu0 = [t.clone() for t in tree.leaves(state["opt"]["mu"])]
        state, m = step(state, batch_to_device(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), rloss, rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
        assert math.isfinite(float(m["grad_norm"]))
        ref = train_state_from_numpy(want, cfg, device="cpu")
        _close_tree(state["opt"]["mu"], ref["opt"]["mu"], f"step {i} mu")
        _close_tree(state["opt"]["nu"], ref["opt"]["nu"], f"step {i} nu")
        assert int(state["opt"]["step"]) == int(ref["opt"]["step"])
        lr = float(lr_at(OPT, i))
        for (path, a), b, m0, m1 in zip(
                tree.leaves_with_paths(state["params"]),
                tree.leaves(ref["params"]), mu0,
                tree.leaves(ref["opt"]["mu"])):
            g = (m1 - OPT.b1 * m0) / (1 - OPT.b1)   # the reference's, clipped
            resolved = g.abs() >= 100 * OPT.eps
            d = (a - b).abs()
            assert bool((d <= ATOL + RTOL * b.abs())[resolved].all()), \
                f"step {i} params/{path}: {float(d[resolved].max())}"
            most = 2 * lr * (1 + OPT.weight_decay * b.abs()) + ATOL
            assert bool((d <= most).all()), f"step {i} params/{path}"
        prev = want


def test_train_steps_match_reference(ref_run):
    """Three steps, each from the reference's state (``_check_steps``), and
    the port's own chain of three steps finite with the step count."""
    cfg, init, batches, states, losses = ref_run
    _check_steps(cfg, init, batches, states, losses)
    for i, (state, loss, gnorm) in enumerate(_port_run(cfg, init,
                                                       batches)):
        assert math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
        assert int(state["opt"]["step"]) == i + 1


def test_remat_changes_nothing(ref_run):
    """``remat="full"`` (each layer under ``torch.utils.checkpoint``) gives
    the same losses, params and moments bit for bit."""
    cfg, init, batches, _, _ = ref_run
    plain = _port_run(cfg, init, batches)
    remat = _port_run(dataclasses.replace(cfg, remat="full"), init, batches)
    for (sa, la, ga), (sb, lb, gb) in zip(plain, remat):
        assert la == lb and ga == gb
        _equal_tree(sa, sb, "remat")


def test_grad_accum_matches_reference_scan():
    """``grad_accum=2``: two microbatches of 2 rows in turn against the
    reference's scanned microbatches, two steps (``_check_steps``)."""
    import jax
    from repro.train.train import init_train_state as ref_init_state
    from repro.train.train import make_train_step as ref_step
    from repro.train.optimizer import AdamWConfig as RefOpt
    cfg = _cfg("qwen3-0.6b")
    rcfg = _ref_cfg(cfg)
    state = ref_init_state(jax.random.PRNGKey(1), rcfg, RefOpt(*OPT))
    init = _np_tree(state)
    batches = _batches(cfg, n=2, seed=5)
    step = jax.jit(ref_step(rcfg, RefOpt(*OPT), grad_accum=2))
    states, losses = [], []
    for b in batches:
        state, m = step(state, b)
        states.append(_np_tree(state))
        losses.append(float(m["loss"]))
    _check_steps(cfg, init, batches, states, losses, grad_accum=2)


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_match_reference(arch):
    """``param_count`` and ``active_param_count`` (MoE: top_k experts) for
    every config (whisper's encoder and cross blocks included)."""
    from repro.models import active_param_count as ref_active
    from repro.models import param_count as ref_count
    cfg = get_config(arch)
    from repro.configs import get_config as ref_get_config
    rcfg = ref_get_config(arch)
    assert param_count(cfg) == ref_count(rcfg)
    assert active_param_count(cfg) == ref_active(rcfg)
    assert (active_param_count(cfg) < param_count(cfg)) == \
        bool(cfg.n_experts)


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_atomic_prune(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(7)}}
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 10, state, metadata={"dp": 4})
    ckpt.save_checkpoint(d, 20, state)
    assert ckpt.latest_step(d) == 20
    restored, step, meta = ckpt.restore_checkpoint(d, state, step=10)
    assert step == 10 and meta == {"dp": 4}
    assert torch.equal(restored["params"]["w"],
                       torch.arange(6.0).reshape(2, 3))
    assert int(restored["opt"]["step"]) == 7
    ckpt.save_checkpoint(d, 30, state)
    ckpt.prune_checkpoints(d, keep=2)
    assert ckpt.latest_step(d) == 30
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, state, step=10)    # pruned
    assert not any(p.name.startswith(".tmp")
                   for p in (tmp_path / "ckpt").iterdir())


def test_checkpoint_refusals(tmp_path):
    d = str(tmp_path / "c2")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, {"w": torch.zeros(2)})
    ckpt.save_checkpoint(d, 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(d, {"w": torch.zeros((3, 3))})
    with pytest.raises(KeyError, match="v"):
        ckpt.restore_checkpoint(d, {"w": torch.zeros((2, 2)),
                                    "v": torch.zeros(1)})


def test_checkpoint_bf16_and_dtypes_bit_for_bit(tmp_path):
    """Every dtype of a train state comes back bit for bit, a bfloat16
    leaf included (NaN and -0.0 too), onto the requested device."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    w[0, 0], w[1, 1] = float("nan"), -0.0
    state = {"params": {"w": w, "n": torch.randn(7, generator=g)},
             "opt": {"mu": [torch.randn(3, generator=g).half()],
                     "step": torch.tensor(3, dtype=torch.int64)},
             "mask": torch.tensor([True, False])}
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    like = tree.tree_map(torch.zeros_like, state)
    got, step, _ = ckpt.restore_checkpoint(str(tmp_path), like,
                                           device="cpu")
    assert step == 3
    for (path, a), (_, b) in zip(tree.leaves_with_paths(got),
                                 tree.leaves_with_paths(state)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.reshape(-1).view(torch.uint8).tolist() == \
            b.reshape(-1).view(torch.uint8).tolist(), path


def test_resume_equals_uninterrupted(tmp_path):
    """Four steps in a row against two, a checkpoint, a restore into a fresh
    state and two more: losses and the final state bit for bit."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                              remat="full")
    from repro_torch.train.train import init_train_state
    batches = [batch_to_device(b, "cpu") for b in _batches(cfg, n=4)]
    step = make_train_step(cfg, OPT)
    state = init_train_state(0, cfg, OPT, device="cpu")
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    state2 = init_train_state(0, cfg, OPT, device="cpu")
    head = [float(step(state2, b)[1]["loss"]) for b in batches[:2]]
    ckpt.save_checkpoint(str(tmp_path), 2, state2, metadata={"dp": 1})
    fresh = init_train_state(1, cfg, OPT, device="cpu")
    fresh, at, meta = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert at == 2 and meta == {"dp": 1}
    _equal_tree(fresh, state2, "restored")
    tail = [float(step(fresh, b)[1]["loss"]) for b in batches[2:]]
    assert head + tail == losses
    _equal_tree(fresh, state, "resumed")


# ---------------------------------------------------------------- stragglers
def _heartbeats(seed, n_steps, n_groups, slow=None):
    rng = np.random.RandomState(seed)
    return [(g, 1.0 + rng.randn() * 0.01 + (3.0 if g == slow else 0.0))
            for _ in range(n_steps) for g in range(n_groups)]


@pytest.mark.parametrize("seed,slow,cfg", [
    (0, 5, StragglerConfig(mad_k=4.0, replace_after=2)),
    (1, None, StragglerConfig()),
    (2, 3, StragglerConfig(window=6, min_heartbeats=2, replace_after=3))])
def test_straggler_detector_matches_reference(seed, slow, cfg):
    """The same heartbeats give the reference's flags, evictions and
    severities after every beat."""
    from repro.train import stragglers as ref
    det = StragglerDetector(cfg)
    rdet = ref.StragglerDetector(ref.StragglerConfig(**vars(cfg)))
    for g, t in _heartbeats(seed, 9, 8, slow):
        det.heartbeat(g, t)
        rdet.heartbeat(g, t)
        assert det.flagged() == rdet.flagged()
        assert det.should_replace() == rdet.should_replace()
        assert det.severity() == rdet.severity()
        assert det.severity(g) == rdet.severity(g)
    if slow is not None:
        assert det.flagged() == [slow] and det.severity() > 1.0


def test_straggler_detection_and_replacement():
    det = StragglerDetector(StragglerConfig(mad_k=4.0, replace_after=2))
    for g, t in _heartbeats(0, 8, 8, slow=5):
        det.heartbeat(g, t)
    assert det.flagged() == [5]
    assert det.severity() > 1.0          # ~3x slower than the median
    det.flagged()
    assert det.should_replace() == [5]


def test_straggler_quiet_cluster_flags_nothing():
    det = StragglerDetector()
    rng = np.random.RandomState(1)
    for _ in range(10):
        for g in range(6):
            det.heartbeat(g, 1.0 + rng.randn() * 0.02)
    assert det.flagged() == []
    assert det.severity() < 0.2


# ------------------------------------------------------------------ launcher
def test_launcher_smoke_on_cpu_and_resume(tmp_path, capsys):
    from repro_torch.launch.train import main
    ck = str(tmp_path / "ck")
    main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "4", "--device",
          "cpu", "--ckpt", ck, "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss=" in out and "4 steps in" in out
    assert ckpt.latest_step(ck) == 4
    main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "5", "--device",
          "cpu", "--ckpt", ck, "--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 4" in out and "[train] step 4 loss=" in out
    loss = float(out.split("step 4 loss=")[1].split()[0])
    assert math.isfinite(loss)


def test_launcher_refuses_a_mesh():
    """Without ``torch.distributed.run`` the world is one process: a mesh
    of more ranks raises, naming both numbers."""
    from repro_torch.launch.train import main
    for flag in ("--dp", "--tp", "--pods"):
        with pytest.raises(ValueError, match="mesh of 2 ranks.*world is one"):
            main(["--arch", "qwen3-0.6b", "--smoke", flag, "2",
                  "--device", "cpu"])


# ------------------------------------------- gradients through the wrappers
def _mha_inputs(rng, dtype=torch.float32, b=2, s=9, h=4, kh=2, d=16):
    mk = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32),
                                     dtype=dtype)
    return mk(b, s, h, d), mk(b, s, kh, d), mk(b, s, kh, d)


def _mlstm_inputs(rng, b=2, s=32, h=2, d=16, dtype=torch.float32):
    mk = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32))
    q, k, v = (mk(b, s, h, d).to(dtype) for _ in range(3))
    return q, k, v, mk(b, s, h), mk(b, s, h) + 2.0


def _scan_inputs(rng, b=2, s=12, d=8, n=4):
    f = lambda x: torch.tensor(np.asarray(x, np.float32))
    return (f(rng.uniform(0.01, 0.5, (b, s, d))),
            f(-rng.uniform(0.5, 2.0, (d, n))), f(rng.randn(b, s, d)),
            f(rng.randn(b, s, n)), f(rng.randn(b, s, n)))


OPS = {
    "mha": (fa, lambda x: fa.mha(*x, causal=True, window=5, softcap=20.0),
            lambda x: fa.mha_plain(*x, causal=True, window=5, softcap=20.0),
            _mha_inputs),
    "mlstm": (ml, lambda x: ml.mlstm(*x, chunk=16, return_state=True),
              lambda x: ml.mlstm_plain(*x, chunk=16, return_state=True),
              _mlstm_inputs),
    "selective_scan": (ms, lambda x: ms.selective_scan(*x, return_state=True),
                       lambda x: ms.selective_scan_plain(
                           *x, return_state=True), _scan_inputs),
}


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in ([o] if isinstance(o, torch.Tensor)
                                     else [o[k] for k in sorted(o)])]


def _grads(fn, inputs, seed=9):
    """Gradients of a random projection of every output of ``fn``."""
    live = [t.clone().requires_grad_(True) for t in inputs]
    outs = _flat(fn(live))
    rng = np.random.RandomState(seed)
    loss = sum((o.float() * torch.tensor(rng.randn(*o.shape).astype(
        np.float32), device=o.device)).sum() for o in outs)
    return [o.detach() for o in outs], torch.autograd.grad(loss, live)


@pytest.mark.parametrize("name", list(OPS))
def test_wrapper_grads_on_cpu_are_autograd_of_plain(name):
    """On the CPU the wrappers run their plain versions under grad too:
    outputs and gradients equal autograd of the plain version, and nothing
    launches."""
    mod, op, plain, make = OPS[name]
    inputs = make(np.random.RandomState(0))
    before = mod.LAUNCHES
    out, got = _grads(op, inputs)
    want_out, want = _grads(plain, inputs)
    assert mod.LAUNCHES == before
    for a, b in zip(out + list(got), want_out + list(want)):
        assert torch.equal(a, b)


def _mlstm_flat(*x):
    out, st = ml.mlstm_plain(*x, chunk=16, return_state=True)
    return out, st["C"], st["n"], st["m"]


def _mlstm_apply(x):
    out, C, n, m = ml.Mlstm.apply(16, *x)
    return out, {"C": C, "n": n, "m": m}


@pytest.mark.parametrize("name", list(OPS))
def test_wrappers_under_grad_refuse_mixed_and_other_devices(name):
    """Under grad too, a mix of devices raises, and so does a device that is
    neither the CPU, a card nor meta (a tensor that reports xpu)."""
    mod, op, _, make = OPS[name]
    inputs = make(np.random.RandomState(2))
    mixed = [inputs[0].to("meta").requires_grad_(True)] + \
        [t.requires_grad_(True) for t in inputs[1:]]
    with pytest.raises(ValueError, match="several devices"):
        op(mixed)
    other = [_elsewhere(t.detach()).requires_grad_(True) for t in inputs]
    with pytest.raises(ValueError, match="cpu or cuda"):
        op(other)


FUNCTIONS = {
    "mha": (fa, "_mha_cuda", lambda q, k, v, **o: fa.mha_plain(q, k, v, **o),
            lambda x: fa.Mha.apply(dict(causal=True, window=5, softcap=20.0,
                                        kv_len=0), *x)),
    "mlstm": (ml, "_mlstm_cuda", _mlstm_flat, _mlstm_apply),
    "selective_scan": (ms, "_scan_cuda",
                       lambda *x: ms.selective_scan_plain(*x,
                                                          return_state=True),
                       lambda x: ms.SelectiveScan.apply(*x)),
}


@pytest.mark.parametrize("name", list(OPS))
def test_autograd_functions_rehearsed_on_cpu(name, monkeypatch):
    """Each wrapper's ``autograd.Function`` with its kernel launch replaced by
    the plain forward (the card's route, rehearsed on the CPU): one forward
    per call, gradients equal to autograd of the plain version bit for bit,
    for every output (unused state outputs included)."""
    mod, attr, fake, apply = FUNCTIONS[name]
    calls = []

    def launch(*args, **kw):
        calls.append(1)
        with torch.no_grad():
            return fake(*args, **kw)

    monkeypatch.setattr(mod, attr, launch)
    _, _, plain, make = OPS[name]
    inputs = make(np.random.RandomState(1))
    out, got = _grads(apply, inputs)
    assert len(calls) == 1
    want_out, want = _grads(plain, inputs)
    for a, b in zip(out + list(got), want_out + list(want)):
        assert torch.equal(a, b)
    # only some inputs requiring grad, and an output whose grad is unused
    live = [t.clone().requires_grad_(i == 0) for i, t in enumerate(inputs)]
    first = _flat(apply(live))[0]
    (g,) = torch.autograd.grad(first.float().sum(), [live[0]])
    ref_live = inputs[0].clone().requires_grad_(True)
    ref_first = _flat(plain([ref_live] + list(inputs[1:])))[0]
    (rg,) = torch.autograd.grad(ref_first.float().sum(), [ref_live])
    assert torch.equal(g, rg)


# --------------------------------------------------------------- on the card
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


CARD_CASES = {
    "mha": [dict(dtype=torch.float32), dict(dtype=torch.bfloat16),
            dict(dtype=torch.bfloat16, b=2, s=300, h=16, kh=8, d=128)],
    "mlstm": [dict(), dict(dtype=torch.bfloat16, s=256, h=4, d=64)],
    "selective_scan": [dict(), dict(b=2, s=77, d=300, n=16)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,case", [(n, i) for n in CARD_CASES
                                       for i in range(len(CARD_CASES[n]))])
def test_wrapper_grads_on_card(card, name, case):
    """On the card under grad: one kernel launch per call, and gradients
    equal to autograd of the plain version on the card (float32 at atol
    1e-4 / rtol 1e-3; bfloat16 within 3e-2 of the largest element)."""
    mod, op, plain, make = OPS[name]
    inputs = [t.to(card) for t in make(np.random.RandomState(case),
                                       **CARD_CASES[name][case])]
    before = mod.LAUNCHES
    _, got = _grads(op, inputs)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    _, want = _grads(plain, inputs)
    assert mod.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            err = float((a.float() - b.float()).abs().max())
            assert err <= 3e-2 * float(b.float().abs().max()), err
        else:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
