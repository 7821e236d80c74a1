"""Op-level cost model of a traced step: FLOPs, HBM bytes and collective
bytes of one rank.

Counterpart of ``repro.launch.hlo_cost``, which reads them from the
partitioned HLO text.  The port has no HLO: :class:`OpLog`, a
``TorchDispatchMode``, records every op of a step as it runs (on ``meta``
tensors in the dry run, ``launch.dryrun``; on the card too, where the same
formulas apply): its name, the shapes and dtypes of its inputs and
outputs, and for a collective the size of its group.  Each call of an LM
kernel is one op (``kernels/observe.py``), as a ``pallas_call`` is one
custom call in the reference's HLO.  Ops on ``DTensor`` objects are
handed to ``DTensor``, whose ops on the local tensors the log then sees;
the ops ``DTensor``'s sharding propagation runs on fake tensors are not
the step's and are not logged.  Identical ops are counted, not repeated:
the log maps each distinct op to the number of times it ran.

:func:`analyze` gives the reference's dict:

- ``flops``: ``torch.utils.flop_counter``'s formulas (the matrix
  products, 2 M N K each, as the reference counts its dots) plus each
  kernel's ``cost``, the products its plain version computes;
- ``hbm_bytes``: each op's operand bytes plus its result bytes, a kernel
  counted once at its boundary; views and allocations (``view``, ``t``,
  ``expand``, ``detach``, ``_unsafe_view``, ``empty``, ...: every op whose
  schema returns an alias of an input without writing it) cost nothing,
  the counterpart of ``_ZERO_COST`` (``hlo_cost.py:31-32``);
- ``collectives``: ``{kind: {count, operand_bytes}}``, the operand bytes of
  each collective on this rank (``launch/cost_analysis.py``); a group of
  one rank moves nothing between devices and is not counted there;
- ``collective_bytes``: their sum.

What has no counterpart: the trace is eager and unrolled.  The layers'
``for`` loop, the microbatches of ``grad_accum`` and the recompute of
``torch.utils.checkpoint`` are each seen op by op, so the reference's
while-loop trip counts (``hlo_cost.py:155-162``, applied at ``:366-376``)
have nothing to read, and neither has its TPU fusion approximation
(``:309-351``): every op's operands and results are charged.
``hbm_bytes`` is therefore the bytes of an unfused eager step, an upper
bound of what the card moves.

:class:`OpLog` also tracks the bytes of the storages that the step's ops
allocate and that are still alive (a weak reference to each storage; a
view shares its base's), and their peak.
"""
from __future__ import annotations

import json
import lzma
import weakref
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import observe
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.mlstm_chunk import ops as ml
from repro_torch.launch.cost_analysis import (COLLECTIVES, collective_kind,
                                              total_collective_bytes)

# each LM kernel's cost(reads, writes, opts) -> (FLOPs, bytes)
KERNELS = {"flash_attention": fa.cost, "flash_decode": fd.cost,
           "mlstm_chunk": ml.cost, "mamba_scan": ms.cost}
KERNEL_PREFIX = "kernel."
# free ops whose schema does not mark their result as a view
_FREE = frozenset({"aten._unsafe_view", "aten.empty", "aten.empty_like",
                   "aten.empty_strided", "aten.new_empty",
                   "aten.new_empty_strided", "aten.lift_fresh",
                   "aten.lift_fresh_copy"})


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: str


class Group(NamedTuple):
    size: int


class Other(NamedTuple):
    name: str


def _group_size(x):
    """The size of a process group (a ``ProcessGroup``, or the
    ``ScriptObject`` the c10d ops receive), None for anything else."""
    import torch.distributed as dist
    if isinstance(x, torch.ScriptObject):
        if not x._type().qualified_name().endswith("c10d.ProcessGroup"):
            return None
        x = dist.ProcessGroup.unbox(x)
    return int(x.size()) if isinstance(x, dist.ProcessGroup) else None


def _enc(x):
    if isinstance(x, torch.Tensor):
        return TensorSpec(tuple(x.shape), str(x.dtype)[6:])
    if isinstance(x, (list, tuple)):
        return tuple(_enc(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return Other(str(x))
    size = _group_size(x)
    if size is not None:
        return Group(size)
    return Other(type(x).__name__)


def _resolve_group(args) -> int:
    """The size of the process group among a collective's (encoded)
    arguments: a ``Group``, or the name of a group."""
    import torch.distributed.distributed_c10d as c10d
    for a in args:
        if isinstance(a, Group):
            return a.size
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except Exception:                # not a group's name
                continue
    raise ValueError(f"no process group among {args}")


class OpLog(TorchDispatchMode):
    """Every op of the block, counted by (name, args, kwargs, outputs,
    group size); see the module docstring."""

    def __init__(self):
        super().__init__()
        self.entries: Dict[tuple, int] = {}
        self._memo: Dict[tuple, tuple] = {}
        self._live: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self._listen = None

    def __enter__(self):
        self._listen = observe.listening(self._kernel)
        self._listen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._listen.__exit__(None, None, None)

    def _add(self, entry: tuple) -> None:
        self.entries[entry] = self.entries.get(entry, 0) + 1

    def _kernel(self, name, reads, writes, opts) -> None:
        self._add((KERNEL_PREFIX + name, _enc(reads),
                   tuple(sorted((k, _enc(v)) for k, v in opts.items())),
                   _enc(writes), None))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)         # sharding propagation
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented                # DTensor: its local ops
        name, collective, fresh = _info(func)
        key = _meta_key(args, kwargs)
        memo = self._memo.get((func, key)) if key is not None else None
        if memo is not None and memo[0] is not None:
            out = _remake(memo[0])
        else:
            out = func(*args, **kwargs)
        if memo is not None:
            entry = memo[1]
        else:
            enc_args = _enc(args)
            group = _resolve_group(enc_args) if collective else None
            entry = (name, enc_args,
                     tuple(sorted((k, _enc(v)) for k, v in kwargs.items())),
                     _enc(out), group)
            if key is not None:
                self._memo[func, key] = (_made(out) if fresh else None,
                                         entry)
        self._add(entry)
        if fresh:
            self._track(out)
        return out

    def _track(self, out) -> None:
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if type(t) is not torch.Tensor:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    @property
    def n_ops(self) -> int:
        return sum(self.entries.values())

    def items(self) -> List[Tuple[tuple, int]]:
        return list(self.entries.items())


_INFO: Dict[object, Tuple[str, bool, bool]] = {}


def _info(func) -> Tuple[str, bool, bool]:
    """(name, whether a collective, whether its results are fresh
    storages: no result aliases an input, and not ``_FREE``)."""
    out = _INFO.get(func)
    if out is None:
        name = str(func)
        packet = name.rsplit(".", 1)[0]
        rets = func._schema.returns
        fresh = packet not in _FREE and not any(
            r.alias_info is not None for r in rets)
        out = _INFO[func] = (name, collective_kind(packet) is not None,
                             fresh)
    return out


# An op's results on meta tensors depend only on its arguments' metadata,
# and computing them runs torch's Python meta functions (~0.1-0.4 ms an
# elementwise op): a step's loops repeat the same ops, so an OpLog keeps,
# by (op, the arguments' shapes, strides, dtypes and other values), the
# op's log entry and, for an op whose results are fresh storages, the
# results' metadata, from which they are made again as new meta tensors.
def _meta_key(args, kwargs):
    """The memo's key of an op's arguments, all of them meta tensors or
    plain values; None where any is something else."""
    try:
        return (_mk(args), _mk(tuple(kwargs.items())) if kwargs else ())
    except _NoKey:
        return None


class _NoKey(Exception):
    pass


_PLAIN = (bool, int, float, str, torch.dtype, torch.device,
          torch.memory_format, torch.layout, type(None))
_META = torch.device("meta")


def _mk(x):
    out = []
    for v in x:
        if v.__class__ is torch.Tensor:
            if v.device != _META:
                raise _NoKey
            out.append((v.size(), v.stride(), v.dtype))
        elif isinstance(v, (list, tuple)):
            out.append(_mk(v))
        elif isinstance(v, _PLAIN):
            out.append(v)
        else:
            raise _NoKey
    return tuple(out)


def _made(out):
    """The metadata of an op's results, or None if they are not all plain
    meta tensors."""
    if type(out) is torch.Tensor:
        if out.device.type != "meta" or out.storage_offset():
            return None
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out:
        made = [_made(t) for t in out]
        return None if any(m is None for m in made) else \
            (type(out), tuple(made))
    return None


def _remake(made):
    if isinstance(made[0], type):
        return made[0]([_remake(m) for m in made[1]])
    shape, stride, dtype = made
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


# ------------------------------------------------------------------ analyze
_SCHEMA_FREE: Dict[str, bool] = {}


def _free_op(name: str) -> bool:
    """A view (every result an alias of an input, not written) or an
    allocation: no bytes moved."""
    packet = name.rsplit(".", 1)[0]
    if packet in _FREE:
        return True
    if name not in _SCHEMA_FREE:
        ns, op, overload = name.split(".")
        try:
            rets = getattr(getattr(getattr(torch.ops, ns), op),
                           overload)._schema.returns
            _SCHEMA_FREE[name] = bool(rets) and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets)
        except (AttributeError, RuntimeError):
            _SCHEMA_FREE[name] = False
    return _SCHEMA_FREE[name]


def _specs(x) -> List[TensorSpec]:
    if isinstance(x, TensorSpec):
        return [x]
    if isinstance(x, tuple):
        return [s for v in x for s in _specs(v)]
    return []


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def _bytes(x) -> int:
    total = 0
    for s in _specs(x):
        n = _itemsize(s.dtype)
        for d in s.shape:
            n *= d
        total += n
    return total


def _shapes(x):
    """Tensor specs as ``torch.Size`` (what flop_counter's formulas read)."""
    if isinstance(x, TensorSpec):
        return torch.Size(x.shape)
    if isinstance(x, tuple) and not isinstance(x, (Group, Other)):
        return tuple(_shapes(v) for v in x)
    return x


_FORMULAS = None


def _formula(packet: str):
    global _FORMULAS
    if _FORMULAS is None:
        from torch.utils.flop_counter import flop_registry
        _FORMULAS = {str(k): fn for k, fn in flop_registry.items()}
    return _FORMULAS.get(packet)


def _kernel_cost(entry) -> Tuple[float, float]:
    name, reads, opts, writes, _ = entry
    fn = KERNELS.get(name[len(KERNEL_PREFIX):])
    if fn is None:
        raise KeyError(f"kernel op {name!r} has no cost formula")
    spec = lambda s: (s.shape, _itemsize(s.dtype))
    f, b = fn([spec(s) for s in _specs(reads)],
              [spec(s) for s in _specs(writes)], dict(opts))
    return float(f), float(b)


def analyze(log) -> Dict:
    """The reference's dict (``hlo_cost.analyze``) from an :class:`OpLog`
    or its items (``(entry, count)`` pairs, as :func:`load` gives them)."""
    items = log.items() if isinstance(log, OpLog) else log
    flops = hbm = 0.0
    coll = {k: {"count": 0, "operand_bytes": 0.0} for k in COLLECTIVES}
    for entry, n in items:
        name, args, kwargs, outs, group = entry
        if name.startswith(KERNEL_PREFIX):
            f, b = _kernel_cost(entry)
            flops += n * f
            hbm += n * b
            continue
        packet = name.rsplit(".", 1)[0]
        kind = collective_kind(packet)
        if kind is not None:
            operand = _bytes(args[kind[1]])
            if group > 1:
                coll[kind[0]]["count"] += n
                coll[kind[0]]["operand_bytes"] += n * operand
            hbm += n * (operand + _bytes(outs))
            continue
        if _free_op(name):
            continue
        fn = _formula(packet)
        if fn is not None:
            flops += n * float(fn(*_shapes(args), out_val=_shapes(outs),
                                   **{k: _shapes(v) for k, v in kwargs}))
        hbm += n * (_bytes(args) + _bytes(tuple(v for _, v in kwargs)) +
                    _bytes(outs))
    return {"flops": flops, "hbm_bytes": hbm, "collectives": coll,
            "collective_bytes": total_collective_bytes(coll)}


# --------------------------------------------------------------- save / load
def _to_json(x):
    if isinstance(x, TensorSpec):
        return {"t": list(x.shape), "d": x.dtype}
    if isinstance(x, Group):
        return {"g": x.size}
    if isinstance(x, Other):
        return {"o": x.name}
    if isinstance(x, tuple):
        return [_to_json(v) for v in x]
    return x


def _from_json(x):
    if isinstance(x, dict):
        if "t" in x:
            return TensorSpec(tuple(x["t"]), x["d"])
        if "g" in x:
            return Group(x["g"])
        return Other(x["o"])
    if isinstance(x, list):
        return tuple(_from_json(v) for v in x)
    return x


def dump(log: OpLog, path) -> None:
    """The log's ops and counts as xz-compressed JSON at ``path``."""
    data = [[_to_json(e), n] for e, n in log.items()]
    with lzma.open(path, "wt") as f:
        json.dump(data, f)


def load(path) -> List[Tuple[tuple, int]]:
    """The ``(entry, count)`` pairs :func:`dump` wrote."""
    with lzma.open(path, "rt") as f:
        return [(_from_json(e), n) for e, n in json.load(f)]
