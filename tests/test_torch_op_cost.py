"""The op-level cost model (``launch/op_cost.py``) against programs with
known costs, the counterpart of ``tests/test_hlo_cost.py``: dot FLOPs,
loops (unrolled here, where the reference multiplies trip counts), bytes,
each collective kind's operand bytes on a fake 16-rank world against a
hand count, and the four LM kernels' meta routes, each one op whose
FLOPs are those ``FlopCounterMode`` counts in its plain version.
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.mlstm_chunk import ops as ml
from repro_torch.launch import cost_analysis, op_cost
from repro_torch.launch.world import fake_world

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _cost(fn, *args):
    with op_cost.OpLog() as log:
        fn(*args)
    return op_cost.analyze(log), log


def test_dot_flops_counted():
    got, _ = _cost(lambda x, y: x @ y, _meta(64, 128), _meta(128, 256))
    assert got["flops"] == 2 * 64 * 128 * 256


def test_python_loop_counts_every_trip():
    """17 trips of a Python loop are 17 of each of its ops: the eager
    trace's counterpart of the reference's while-loop trip count."""
    def loop(x):
        for _ in range(17):
            x = x @ x * 1e-3
        return x
    got, log = _cost(loop, _meta(64, 64))
    assert got["flops"] == 17 * 2 * 64 ** 3
    mm = [n for e, n in log.items() if e[0] == "aten.mm.default"]
    assert mm == [17]                  # one distinct op, counted 17 times


def test_nested_loop_multiplies():
    def loop(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x * 1e-3
        return x
    got, _ = _cost(loop, _meta(32, 32))
    assert got["flops"] == 15 * 2 * 32 ** 3


def test_bytes_positive_and_views_free():
    x = _meta(128, 128)
    got, _ = _cost(lambda x: torch.tanh(x @ x), x)
    assert got["hbm_bytes"] >= 3 * 128 * 128 * 4   # two reads + one write
    # mm: 2 reads + 1 write; tanh: 1 read + 1 write
    assert got["hbm_bytes"] == 5 * 128 * 128 * 4
    views, _ = _cost(lambda x: (x.view(64, 256), x.t(), x[None].expand(
        3, 128, 128), x.detach(), x.reshape(-1), x.permute(1, 0)), x)
    assert views["hbm_bytes"] == 0 and views["flops"] == 0
    alloc, _ = _cost(lambda: torch.empty(1000, device=META))
    assert alloc["hbm_bytes"] == 0


def test_backward_counted_op_by_op():
    a = _meta(8, 16).requires_grad_(True)
    b = _meta(16, 4).requires_grad_(True)

    def step(a, b):
        (a @ b).sum().backward()
    got, _ = _cost(step, a, b)
    assert got["flops"] == 3 * 2 * 8 * 16 * 4     # forward + two grads


def _world_collectives(kind: str):
    """One collective of ``kind`` on a group of 4 ranks of a fake 16-rank
    world (mesh (4, 4), the "model" dim), and its hand count: (op log,
    operand bytes)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                      mesh_dim_names=("data", "model"))
    g = mesh.get_group("model")
    x = _meta(8, 6, dtype=torch.bfloat16)           # 96 bytes
    with op_cost.OpLog() as log:
        if kind == "all-reduce":
            dist.all_reduce(x, group=g)
        elif kind == "all-gather":
            dist.all_gather_into_tensor(x.new_empty(32, 6), x, group=g)
            # DTensor's own gather: a functional all_gather
            DTensor.from_local(x, mesh, (Shard(0), Shard(1)),
                               run_check=False).redistribute(
                mesh, (Shard(0), Shard(0)))
        elif kind == "reduce-scatter":
            dist.reduce_scatter_tensor(x.new_empty(2, 6), x, group=g)
        elif kind == "all-to-all":
            dist.all_to_all_single(torch.empty_like(x), x, group=g)
    return log, 96


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all"])
def test_collective_operand_bytes(kind):
    with fake_world(16):
        log, hand = _world_collectives(kind)
    got = op_cost.analyze(log)["collectives"]
    n = 2 if kind == "all-gather" else 1
    assert got[kind] == {"count": n, "operand_bytes": float(n * hand)}
    assert all(v["count"] == 0 for k, v in got.items() if k != kind)
    assert all(e[4] == 4 for e, _ in log.items()
               if cost_analysis.collective_kind(e[0].rsplit(".", 1)[0]))
    assert not dist.is_initialized()


def test_group_of_one_rank_is_no_collective():
    with fake_world(16):
        g = dist.new_group([0])
        x = _meta(10)
        with op_cost.OpLog() as log:
            dist.all_reduce(x, group=g)
    got = op_cost.analyze(log)
    assert got["collective_bytes"] == 0
    assert got["hbm_bytes"] == 2 * 40


def test_unmapped_collective_raises():
    assert cost_analysis.collective_kind("aten.mm") is None
    assert cost_analysis.collective_kind(
        "_c10d_functional.wait_tensor") is None
    with pytest.raises(KeyError, match="no kind"):
        cost_analysis.collective_kind("c10d.broadcast_")


def test_fake_world_is_destroyed_on_error():
    with pytest.raises(RuntimeError, match="inside"):
        with fake_world(8):
            assert dist.get_world_size() == 8
            raise RuntimeError("inside")
    assert not dist.is_initialized()


def test_roofline_on_h100_constants():
    assert cost_analysis.PEAK_FLOPS == 989e12
    assert cost_analysis.HBM_BW == 3.35e12
    assert cost_analysis.LINK_BW == 50e9
    t = cost_analysis.roofline_terms(989e12, 3.35e12 * 2, 50e9 * 3)
    assert t == {"t_compute": 1.0, "t_memory": 2.0, "t_collective": 3.0}
    assert cost_analysis.dominant_term(t) == "t_collective"


def test_log_round_trip(tmp_path):
    x = _meta(16, 32)
    _, log = _cost(lambda x: torch.softmax(x @ x.t(), -1).sum(0), x)
    path = tmp_path / "cell.ops.json.xz"
    op_cost.dump(log, path)
    assert op_cost.analyze(op_cost.load(path)) == op_cost.analyze(log)
    assert sum(n for _, n in op_cost.load(path)) == log.n_ops


# ------------------------------------------------------------ the kernels
def _mha_args(rng, b=2, sq=37, sk=37, h=8, kh=2, d=64):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


def _decode_args(rng, b=3, s=100, h=8, kh=2, d=64):
    q, k, v = _mha_args(rng, b, 1, s, h, kh, d)
    return [q, k, v, 57]


def _mlstm_args(rng, b=2, s=64, h=4, d=16):
    x = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)) for _ in range(3)]
    g = [torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32))
         for _ in range(2)]
    return x + g


def _scan_args(rng, b=2, s=10, d=12, n=4):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return [f(b, s, d).abs() * 0.1, -f(d, n).abs(), f(b, s, d), f(b, s, n),
            f(b, s, n)]


KERNELS = {
    "flash_attention": (fa.mha, fa.mha_plain, _mha_args,
                        [dict(causal=True), dict(causal=False, window=5),
                         dict(return_lse=True, k_offset=3)]),
    "flash_decode": (fd.decode_attn, fd.decode_attn_plain, _decode_args,
                     [dict(), dict(window=16, softcap=30.0)]),
    "mlstm_chunk": (ml.mlstm, ml.mlstm_plain, _mlstm_args,
                    [dict(chunk=16), dict(chunk=64, return_state=True),
                     dict(chunk=128, return_state=True)]),
    "mamba_scan": (ms.selective_scan, ms.selective_scan_plain, _scan_args,
                   [dict(), dict(return_state=True)]),
}
CASES = [(k, i) for k, v in KERNELS.items() for i in range(len(v[3]))]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return list(out.values())
    return [t for o in out for t in _flat(o)]


def _to_meta(args):
    return [a.to(META) if isinstance(a, torch.Tensor) else a for a in args]


@pytest.mark.parametrize("name,case", CASES)
def test_kernel_meta_route_gives_the_plain_outputs(name, case):
    """On meta tensors each wrapper gives its plain version's output
    shapes and dtypes (log-sum-exps and final states included), as one
    kernel op, and launches nothing."""
    op, plain, make, opts = KERNELS[name]
    opts = opts[case]
    args = make(np.random.RandomState(case))
    mod = {"flash_attention": fa, "flash_decode": fd, "mlstm_chunk": ml,
           "mamba_scan": ms}[name]
    before = mod.LAUNCHES
    with op_cost.OpLog() as log:
        got = _flat(op(*_to_meta(args), **opts))
    want = _flat(plain(*args, **opts))
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert mod.LAUNCHES == before
    kernels = [(e, n) for e, n in log.items()
               if e[0].startswith(op_cost.KERNEL_PREFIX)]
    assert [(e[0], n) for e, n in kernels] == [("kernel." + name, 1)]


@pytest.mark.parametrize("name,case", CASES)
def test_kernel_flops_equal_flop_counter_of_plain(name, case):
    """Each kernel's FLOP formula is what ``FlopCounterMode`` counts in its
    plain version at the same shapes (so kernel and plain version count
    the same work), and its bytes are its operands read and results
    written once."""
    op, plain, make, opts = KERNELS[name]
    opts = opts[case]
    args = make(np.random.RandomState(10 + case))
    with FlopCounterMode(display=False) as fc:
        plain(*args, **opts)
    got, log = _cost(lambda: op(*_to_meta(args), **opts))
    assert got["flops"] == fc.get_total_flops() > 0
    (entry, _), = [(e, n) for e, n in log.items()
                   if e[0].startswith(op_cost.KERNEL_PREFIX)]
    reads = sum(math.prod(t.shape) * t.element_size()
                for t in args if isinstance(t, torch.Tensor))
    outs = sum(math.prod(s.shape) * 4 for s in op_cost._specs(entry[3]))
    if name == "flash_decode":           # only the visible rows are read
        q, k = args[0], args[1]
        r0, r1 = dict(entry[2])["rows"]
        reads = q.numel() * 4 + 2 * k.shape[0] * (r1 - r0) * \
            k.shape[2] * k.shape[3] * 4
    assert _kernel_bytes(entry) == reads + outs


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


def _kernel_bytes(entry) -> float:
    return op_cost._kernel_cost(entry)[1]


@pytest.mark.parametrize("name", ["flash_attention", "mlstm_chunk",
                                  "mamba_scan"])
def test_kernel_meta_route_under_grad(name):
    """Under grad the autograd Function takes the meta route forward (one
    kernel op) and its backward is the plain VJP, counted op by op: the
    recomputed plain forward's products plus its VJP's."""
    op, plain, make, opts = KERNELS[name]
    args = make(np.random.RandomState(3))
    live = [a.to(META).requires_grad_(True) if isinstance(a, torch.Tensor)
            else a for a in args]

    def step():
        outs = _flat(op(*live))
        torch.autograd.grad(outs[0].float().sum(), _tensors(live))
    got, log = _cost(step)
    kernels = [n for e, n in log.items()
               if e[0].startswith(op_cost.KERNEL_PREFIX)]
    assert kernels == [1]
    with FlopCounterMode(display=False) as fc:
        cpu = [a.clone().requires_grad_(True) if isinstance(a, torch.Tensor)
               else a for a in args]
        outs = _flat(plain(*cpu))
        torch.autograd.grad(outs[0].float().sum(), _tensors(cpu))
    fwd = op_cost._kernel_cost(next(e for e, _ in log.items()
                                    if e[0].startswith("kernel.")))[0]
    # forward kernel + (the plain forward recomputed + its VJP)
    assert got["flops"] == fwd + fc.get_total_flops()


# --------------------------------------------------------------- on the card
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
@pytest.mark.parametrize("name,case", CASES)
def test_kernel_on_card_logged_as_its_meta_route(card, name, case):
    """A launch on the card is logged as the same op as the meta route's
    call at the same shapes (the same entry, so the same FLOPs and bytes),
    once per launch."""
    op, _, make, opts = KERNELS[name]
    opts = opts[case]
    args = make(np.random.RandomState(20 + case))
    mod = {"flash_attention": fa, "flash_decode": fd, "mlstm_chunk": ml,
           "mamba_scan": ms}[name]
    logs = []
    for dev in (META, card):
        moved = [a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args]
        before = mod.LAUNCHES
        with op_cost.OpLog() as log:
            op(*moved, **opts)
        torch.cuda.synchronize()
        logs.append([(e, n) for e, n in log.items()
                     if e[0].startswith(op_cost.KERNEL_PREFIX)])
        assert mod.LAUNCHES - before == (dev == card)
    assert logs[0] == logs[1] and len(logs[0]) == 1
