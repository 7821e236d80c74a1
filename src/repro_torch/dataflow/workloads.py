"""The paper's benchmark jobs (Table II) and their datasets (§V-B.2).

Jobs are iterative Spark-MLlib analogues expressed as sequences of component
stage-DAGs with Ernest-form ground-truth runtimes; the dataset statistics
(size, features) parameterize the stage cost model.  A numpy copy of
``repro.dataflow.workloads`` (its synthetic-data generators, which no part
of the port runs yet, are left out; ``Dataset.generator`` still names them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


# ------------------------------------------------------------------ datasets
@dataclass(frozen=True)
class Dataset:
    name: str
    size_gb: float
    n_features: int
    generator: str


DATASETS = {
    "multiclass": Dataset("Multiclass", 27.0, 200, "make_multiclass"),
    "vandermonde": Dataset("Vandermonde", 35.0, 19, "make_vandermonde"),
    "points": Dataset("Points", 48.0, 2, "make_points"),
}


# ------------------------------------------------------------------- stages
@dataclass(frozen=True)
class StageSpec:
    """Ground-truth runtime: t(s) = serial + parallel/s + comm*log2(s) + lin*s,
    modulated by interference / locality / failures in the simulator."""
    name: str
    serial: float          # fixed seconds
    parallel: float        # perfectly-parallel seconds (at s=1)
    comm: float            # log-term (aggregation trees)
    lin: float = 0.0       # per-executor overhead (broadcast etc.)
    cpu: float = 0.7       # nominal CPU utilisation metric
    shuffle: float = 0.1   # nominal shuffle r/w metric
    io: float = 0.1        # nominal data I/O metric

    def runtime(self, s: float) -> float:
        return (self.serial + self.parallel / s +
                self.comm * np.log2(max(s, 2)) + self.lin * s)


@dataclass(frozen=True)
class JobSpec:
    name: str
    dataset: Dataset
    iterations: int
    params: str                       # textual job parameters (hashed context)
    prep: Tuple[StageSpec, ...]       # component 0
    iter_stages: Tuple[StageSpec, ...]  # components 1..iterations (chain DAG)
    final: Tuple[StageSpec, ...]      # last component

    @property
    def n_components(self) -> int:
        return self.iterations + 2

    def stages(self, comp_idx: int) -> Tuple[StageSpec, ...]:
        if comp_idx == 0:
            return self.prep
        if comp_idx == self.n_components - 1:
            return self.final
        return self.iter_stages

    def base_runtime(self, s: float) -> float:
        return sum(st.runtime(s) for c in range(self.n_components)
                   for st in self.stages(c))


def _scale(ds: Dataset, per_gb: float) -> float:
    return per_gb * ds.size_gb


def build_jobs() -> Dict[str, JobSpec]:
    mc, vm, pt = DATASETS["multiclass"], DATASETS["vandermonde"], DATASETS["points"]
    jobs = {}
    jobs["lr"] = JobSpec(
        name="LR", dataset=mc, iterations=20, params="20 iterations",
        prep=(StageSpec("read-cache", 4.0, _scale(mc, 14.0), 0.4, io=0.9, cpu=0.3),
              StageSpec("count", 1.0, _scale(mc, 1.0), 0.3, io=0.3, cpu=0.2)),
        iter_stages=(StageSpec("broadcast-weights", 0.8, 0.0, 0.35, 0.04,
                               cpu=0.1, shuffle=0.3),
                     StageSpec("map-gradient", 1.0, _scale(mc, 4.2), 0.0,
                               cpu=0.9, io=0.15),
                     StageSpec("tree-aggregate", 0.6, _scale(mc, 0.3), 0.8,
                               cpu=0.3, shuffle=0.8)),
        final=(StageSpec("model-save", 2.0, 2.0, 0.2, io=0.6, cpu=0.2),))
    jobs["mpc"] = JobSpec(
        name="MPC", dataset=mc, iterations=20,
        params="20 iterations, 4 layers with 200-100-50-3 perceptrons",
        prep=(StageSpec("read-cache", 4.0, _scale(mc, 14.0), 0.4, io=0.9, cpu=0.3),
              StageSpec("init-weights", 1.5, 1.0, 0.2, cpu=0.2)),
        iter_stages=(StageSpec("broadcast-weights", 1.0, 0.0, 0.4, 0.06,
                               cpu=0.1, shuffle=0.35),
                     StageSpec("fwd-bwd", 1.2, _scale(mc, 10.5), 0.0,
                               cpu=0.95, io=0.1),
                     StageSpec("tree-aggregate", 0.8, _scale(mc, 0.5), 1.0,
                               cpu=0.3, shuffle=0.85)),
        final=(StageSpec("model-save", 2.0, 2.0, 0.2, io=0.6, cpu=0.2),))
    jobs["kmeans"] = JobSpec(
        name="K-Means", dataset=pt, iterations=10,
        params="10 iterations, 8 clusters",
        prep=(StageSpec("read-cache", 4.0, _scale(pt, 11.0), 0.4, io=0.9, cpu=0.3),
              StageSpec("init-centers", 1.0, _scale(pt, 0.6), 0.5,
                        cpu=0.4, shuffle=0.3)),
        iter_stages=(StageSpec("assign-points", 1.0, _scale(pt, 5.0), 0.0,
                               cpu=0.85, io=0.1),
                     StageSpec("update-centers", 0.6, _scale(pt, 0.5), 0.9,
                               cpu=0.3, shuffle=0.75)),
        final=(StageSpec("model-save", 1.5, 1.5, 0.2, io=0.6, cpu=0.2),))
    jobs["gbt"] = JobSpec(
        name="GBT", dataset=vm, iterations=10,
        params='10 iterations, "Regression" configuration',
        # GBT decomposes into many small stages per boosting round (paper:
        # "internally decomposed into many components")
        prep=(StageSpec("read-cache", 4.0, _scale(vm, 12.0), 0.4, io=0.9, cpu=0.3),
              StageSpec("bin-features", 2.0, _scale(vm, 2.2), 0.5, cpu=0.6)),
        iter_stages=(StageSpec("predict-residual", 0.8, _scale(vm, 1.6), 0.0,
                               cpu=0.8, io=0.1),
                     StageSpec("hist-level-1", 0.5, _scale(vm, 1.2), 0.7,
                               cpu=0.7, shuffle=0.6),
                     StageSpec("hist-level-2", 0.5, _scale(vm, 1.0), 0.7,
                               cpu=0.7, shuffle=0.6),
                     StageSpec("hist-level-3", 0.5, _scale(vm, 0.8), 0.7,
                               cpu=0.7, shuffle=0.6),
                     StageSpec("choose-splits", 0.4, _scale(vm, 0.2), 0.9,
                               cpu=0.3, shuffle=0.8)),
        final=(StageSpec("model-save", 1.5, 1.5, 0.2, io=0.6, cpu=0.2),))
    return jobs


JOBS = build_jobs()
SCALEOUT_RANGE = (4, 36)          # Spark executors (paper §V-A)


def scale_job(job: JobSpec, size_scale: float) -> JobSpec:
    """The same job on a ``size_scale``-times larger (or smaller) dataset:
    the data-dependent (perfectly-parallel) term of every stage scales with
    the input size while serial/communication terms stay fixed — the
    dataset-size axis of cross-context evaluation (C3O-style)."""
    import dataclasses

    def sc(stages):
        return tuple(dataclasses.replace(s, parallel=s.parallel * size_scale)
                     for s in stages)

    ds = dataclasses.replace(job.dataset,
                             size_gb=job.dataset.size_gb * size_scale)
    return dataclasses.replace(job, dataset=ds, prep=sc(job.prep),
                               iter_stages=sc(job.iter_stages),
                               final=sc(job.final))
