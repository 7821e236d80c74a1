"""Elastic training runtime driven by Enel (beyond-paper integration).

Counterpart of ``repro.train.elastic``.  The trainer treats a training job
as an iterative dataflow: every ``steps_per_component`` optimizer steps
form one *component* whose stages (data-load, train-step, checkpoint) are
timed and attributed like the paper's Spark task sets.  At each component
boundary Enel predicts the remaining runtime for every candidate DP degree
and the trainer re-meshes (checkpoint -> rebuild -> restore) when the
runtime target demands it.  A simulated worker-group loss shrinks the DP
degree and restarts from the latest checkpoint: the paper's §V-B.4
scenario on an ML job.

On a process group (``torch.distributed`` initialised by the caller: NCCL
on cards, gloo on the CPU) a DP degree is a mesh: ``_build(dp)`` takes
``launch.mesh.make_mesh(dp, ecfg.tp)`` over the world's first ``dp * tp``
ranks (made at the degree's first use and kept for the run) and places the state by ``launch.shardings.state_shardings`` (a
re-mesh restores the checkpoint resharded onto the new mesh), and every
step is the sharded train step, each rank computing its rows of the
global batch.  A DP degree above the world's size raises.  Ranks outside
the current mesh idle through a component, as the reference's spare
devices do, but join every collective of the world: mesh creation, the
checkpoint barrier and the broadcasts below.  The stage times are rank
0's clock, broadcast to every rank, so that every rank builds the same
graphs and Enel (trained on every rank) picks the same degree on each;
the run checks that the picks agree (``picks``).

Without a process group it runs on one device, and ``dp`` is the
*logical* DP degree that Enel picks: it is recorded in the component logs,
the stage contexts and the checkpoint metadata; every step computes the
whole global batch, which is what the sharded step computes.  A change of
``dp`` saves a checkpoint, rebuilds the step and restores the saved state
onto the device; the failure path restores the latest checkpoint the same
way.  So the re-mesh cost Enel observes is the real checkpoint round trip.

Stage times come from this module's own ``time`` (``time.time()``), read
where the reference reads it, so that a test can script both clocks; the
train-step time ends with a host read of the loss, which waits for the
device (the reference's ``block_until_ready``).  The stage contexts
describe the execution context the port has: the device's name
(:data:`PLATFORM`, the card's lower-cased name or "cpu" when None) and
:data:`SOFTWARE`, where the reference writes "tpu v5e" and ["jax", "xla"].
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.autoencoder import embed_properties, train_autoencoder
from repro_torch.core.encoding import encode_properties
from repro_torch.core.graph import (ComponentGraph, NodeAttrs, build_graph,
                                    historical_summary, summary_node)
from repro_torch.core.scaling import EnelScaler
from repro_torch.core.training import EnelTrainer
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import (logical_rules, shard_tree,
                                          state_shardings)
from repro_torch.launch.specs import state_specs
from repro_torch.models.sharding import use_rules
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train import (batch_to_device, init_train_state,
                                     make_train_step)

# the execution context the stage contexts describe (None: the device's
# own name); a parity test sets the reference's strings here
PLATFORM: Optional[str] = None
SOFTWARE: List[str] = ["torch", "cuda"]

STAGES = ("data-load", "train-step", "checkpoint")


def platform_name(device: torch.device) -> str:
    """:data:`PLATFORM`, or the card's lower-cased name, or "cpu"."""
    if PLATFORM is not None:
        return PLATFORM
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).lower()
    return device.type


class TrainContextEncoder:
    """Context vectors for training-stage nodes (same encoding substrate)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, *,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        props = self._base_props() + list(STAGES)
        self.ae, _ = train_autoencoder(encode_properties(props), steps=200,
                                       seed=seed, device=self.device)
        self._cache: Dict[str, np.ndarray] = {}

    def _base_props(self) -> List:
        c = self.cfg
        return [c.name, c.family, int(c.n_layers), int(c.d_model),
                int(c.n_heads), platform_name(self.device),
                int(c.vocab_size)]

    def context(self, stage: str, dp: int) -> np.ndarray:
        key = f"{stage}:{dp}"
        if key not in self._cache:
            u = embed_properties(self.ae, encode_properties(
                self._base_props())).mean(0)
            v = embed_properties(self.ae, encode_properties(
                SOFTWARE)).mean(0)
            w = embed_properties(self.ae, encode_properties(
                [stage, int(dp)])).mean(0)
            self._cache[key] = np.concatenate([u, v, w]).astype(np.float32)
        return self._cache[key]


@dataclass
class ElasticConfig:
    target_runtime: float                  # seconds for the whole job
    n_components: int = 6
    steps_per_component: int = 4
    dp_choices: Tuple[int, ...] = (1, 2, 4, 8)
    tp: int = 1
    ckpt_dir: str = "checkpoints/elastic"
    ckpt_every_components: int = 1
    fail_at_component: Optional[int] = None  # simulated worker-group loss
    seed: int = 0


@dataclass
class ComponentLog:
    comp_idx: int
    dp: int
    runtime: float
    stage_times: Dict[str, float]
    rescaled_from: Optional[int] = None
    failed: bool = False


def _world() -> Optional[int]:
    """The world's size, or None without a process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


class ElasticTrainer:
    """The Enel-driven elastic loop on ``device`` (the card unless the
    caller asks for the CPU; on a process group, this rank's device).
    ``losses`` holds every step this rank computed, its loss read on the
    host; ``picks`` every decision's DP degree (on a process group, checked
    equal on every rank)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 ecfg: ElasticConfig, opt: Optional[AdamWConfig] = None, *,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.shape = shape
        self.ecfg = ecfg
        self.device = resolve_device(device)
        self.opt = opt or AdamWConfig(warmup_steps=2, total_steps=200)
        self.dcfg = DataConfig(seed=ecfg.seed)
        self.encoder = TrainContextEncoder(cfg, seed=ecfg.seed,
                                           device=self.device)
        self.enel = EnelTrainer(seed=ecfg.seed, device=self.device)
        self.scaler = EnelScaler(self.enel,
                                 (min(ecfg.dp_choices), max(ecfg.dp_choices)))
        self.logs: List[ComponentLog] = []
        self.graphs: List[ComponentGraph] = []
        self.losses: List[float] = []
        self.picks: List[int] = []
        self.global_step = 0
        self._step_fn = None
        self._state = None
        self._dp = max(ecfg.dp_choices)
        self.world = _world()
        self._mesh = None
        self._meshes: Dict[Tuple[int, int], object] = {}
        self._rules = None

    # -------------------------------------------------------------- re-mesh
    def _build(self, dp: int, restore_from: Optional[str] = None) -> None:
        """(Re)build the step at DP degree ``dp``; optionally restore the
        latest checkpoint under ``restore_from`` (on a process group,
        resharded onto the new mesh)."""
        ecfg = self.ecfg
        self._dp = dp
        if self.world is not None:
            self._build_mesh(dp, restore_from)
            return
        if self._state is None:
            self._state = init_train_state(ecfg.seed, self.cfg, self.opt,
                                           device=self.device)
        if restore_from is not None:
            self._state, _, _ = restore_checkpoint(restore_from, self._state,
                                                   device=self.device)
        self._step_fn = make_train_step(self.cfg, self.opt)

    def _build_mesh(self, dp: int, restore_from: Optional[str]) -> None:
        ecfg = self.ecfg
        if dp * ecfg.tp > self.world:
            raise ValueError(f"DP degree {dp} x TP {ecfg.tp} needs "
                             f"{dp * ecfg.tp} ranks; the world has "
                             f"{self.world}")
        first = self._mesh is None
        # one mesh per degree, made once: a mesh's process groups (an NCCL
        # communicator each) live as long as the world, so a new mesh at
        # every re-mesh would leak them; every rank takes the same degrees
        # in the same order, so every rank hits or misses alike
        key = (dp, ecfg.tp)
        if key not in self._meshes:
            self._meshes[key] = make_mesh(dp, ecfg.tp,
                                          device_type=self.device.type)
        self._mesh = self._meshes[key]
        self._rules = logical_rules(self.cfg, self._mesh, self.shape)
        self._state = self._step_fn = None
        if not self.in_mesh:
            return
        template = state_specs(self.cfg, self.opt)
        specs = state_shardings(self.cfg, self._mesh, template)
        if restore_from is not None:
            self._state, _, _ = restore_checkpoint(
                restore_from, template, device=self.device, shardings=specs,
                mesh=self._mesh)
        else:
            assert first, "a re-mesh restores the saved state"
            self._state = shard_tree(
                init_train_state(ecfg.seed, self.cfg, self.opt,
                                 device=self.device), self._mesh, specs)
        self._step_fn = make_train_step(self.cfg, self.opt)

    @property
    def in_mesh(self) -> bool:
        """Whether this rank computes steps (always without a process
        group)."""
        return self._mesh is None or self._mesh.get_coordinate() is not None

    def _save(self) -> None:
        if self.in_mesh:
            save_checkpoint(self.ecfg.ckpt_dir, self.global_step,
                            self._state, metadata={"dp": self._dp})
        else:                        # the writers' barrier
            import torch.distributed as dist
            dist.barrier()

    # ------------------------------------------------------------ components
    def _run_component(self, comp_idx: int,
                       rescaled_from: Optional[int]) -> ComponentLog:
        ecfg = self.ecfg
        t_data = t_step = 0.0
        for _ in range(ecfg.steps_per_component):
            if not self.in_mesh:                  # a spare rank idles
                self.global_step += 1
                continue
            t0 = time.time()
            batch = global_batch(self.dcfg, self.cfg, self.shape,
                                 self.global_step,
                                 seq_len=self.shape.seq_len)
            batch = batch_to_device(batch, self.device)
            t_data += time.time() - t0
            t0 = time.time()
            with use_rules(self._mesh, self._rules):
                self._state, metrics = self._step_fn(self._state, batch)
            loss = float(metrics["loss"])         # waits for the device
            t_step += time.time() - t0
            self.losses.append(loss)
            self.global_step += 1
        t_ckpt = 0.0
        if comp_idx % ecfg.ckpt_every_components == 0:
            t0 = time.time()
            self._save()
            t_ckpt = time.time() - t0
        if self.world is not None:               # rank 0's clock everywhere
            import torch.distributed as dist
            times = [(t_data, t_step, t_ckpt)]
            dist.broadcast_object_list(times, src=0)
            t_data, t_step, t_ckpt = times[0]
        log = ComponentLog(comp_idx, self._dp, t_data + t_step + t_ckpt,
                           {"data-load": t_data, "train-step": t_step,
                            "checkpoint": t_ckpt},
                           rescaled_from=rescaled_from)
        self.logs.append(log)
        return log

    def _component_nodes(self, log: ComponentLog) -> List[NodeAttrs]:
        nodes = []
        a = float(log.rescaled_from or log.dp)
        spc = self.ecfg.steps_per_component
        for i, stage in enumerate(STAGES):
            t = log.stage_times[stage]
            thr = spc / max(log.stage_times["train-step"], 1e-3)
            metrics = np.array([
                min(1.0, thr / 10.0),                  # throughput proxy
                1.0 / log.dp,                          # comm share proxy
                log.stage_times["data-load"] / max(log.runtime, 1e-6),
                0.05, 0.0], np.float32)
            nodes.append(NodeAttrs(
                name=stage, context=self.encoder.context(stage, log.dp),
                metrics=metrics, start_scaleout=a if i == 0 else log.dp,
                end_scaleout=log.dp, time_fraction=1.0, runtime=t,
                overhead=None))
        return nodes

    def _future_builder(self, comp_idx: int, a: float, z: float,
                        preds: List[NodeAttrs]) -> ComponentGraph:
        nodes = []
        for i, stage in enumerate(STAGES):
            nodes.append(NodeAttrs(
                name=stage, context=self.encoder.context(stage, int(z)),
                metrics=None, start_scaleout=a if i == 0 else z,
                end_scaleout=z, time_fraction=1.0 if a == z else 0.8))
        return _log_graph(nodes, preds, comp_idx)

    # ----------------------------------------------------------------- run
    def run(self) -> Dict:
        ecfg = self.ecfg
        self._build(self._dp)
        elapsed = 0.0
        prev_summary = None
        rescaled_from = None
        for comp_idx in range(ecfg.n_components):
            if ecfg.fail_at_component == comp_idx and self._dp > min(
                    ecfg.dp_choices):
                # simulated worker-group failure: shrink DP, restart from ckpt
                new_dp = max(d for d in ecfg.dp_choices if d < self._dp)
                rescaled_from = self._dp
                self._build(new_dp, restore_from=ecfg.ckpt_dir)
                self.logs.append(ComponentLog(comp_idx, new_dp, 0.0, {},
                                              rescaled_from, failed=True))
            log = self._run_component(comp_idx, rescaled_from)
            rescaled_from = None
            elapsed += log.runtime
            nodes = self._component_nodes(log)
            preds = [p for p in (prev_summary,) if p is not None]
            if comp_idx > 0:
                h = historical_summary(
                    self.scaler.hist_summaries.get(comp_idx - 1, []),
                    float(self._dp))
                if h is not None:
                    preds.append(h)
            self.graphs.append(_log_graph(nodes, preds, comp_idx))
            self.scaler.record_component(comp_idx, nodes, log.runtime)
            prev_summary = summary_node(nodes, f"P{comp_idx}")
            # fine-tune + recommend
            if comp_idx < ecfg.n_components - 1:
                self.enel.observe_run(self.graphs, retrain_every=10 ** 9,
                                      steps=0, fine_tune_steps=40)
                # the batched sweep evaluates _future_builder's context at
                # the current dp for every candidate (only a/z/r and the H
                # summary vary), as the reference's does: dp_new snaps to
                # the coarse dp_choices grid below
                dp_new, pred, _ = self.scaler.recommend(
                    graph_builder=self._future_builder,
                    next_comp=comp_idx + 1, n_components=ecfg.n_components,
                    elapsed=elapsed, current_scaleout=self._dp,
                    target_runtime=ecfg.target_runtime,
                    current_summary=prev_summary)
                dp_new = min(ecfg.dp_choices,
                             key=lambda d: abs(d - dp_new))   # snap to choices
                self._agree(dp_new)
                if dp_new != self._dp:
                    rescaled_from = self._dp
                    self._save()
                    self._build(dp_new, restore_from=ecfg.ckpt_dir)
        return {
            "elapsed": elapsed, "target": ecfg.target_runtime,
            "met_target": elapsed <= ecfg.target_runtime,
            "dp_trace": [l.dp for l in self.logs],
            "final_step": self.global_step,
            "n_rescales": sum(1 for l in self.logs
                              if l.rescaled_from is not None),
        }


    def _agree(self, dp: int) -> None:
        """Record a pick; on a process group, raise unless every rank
        picked it."""
        self.picks.append(dp)
        if self.world is None:
            return
        import torch.distributed as dist
        every = [None] * self.world
        dist.all_gather_object(every, dp)
        if len(set(every)) != 1:
            raise RuntimeError(f"ranks picked different DP degrees at "
                               f"component {len(self.picks) - 1}: {every}")


def _log_graph(nodes: List[NodeAttrs], preds: List[NodeAttrs],
               comp_idx: int) -> ComponentGraph:
    n = len(nodes)
    edges = [(i, i + 1) for i in range(n - 1)]
    edges += [(n + j, 0) for j in range(len(preds))]
    return build_graph(nodes + preds, edges, component_id=comp_idx)
