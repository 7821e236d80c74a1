"""Job execution-context encoding: descriptive properties -> c = u ‖ v ‖ w.

u: always-available properties (job signature, dataset, hardware),
v: not-uniformly-recorded properties (software versions; randomly missing),
w: properties unique to the task set (stage name, #tasks, attempt id).
Each property runs through the hasher/binarizer (eq.1-2), then the trained
auto-encoder; group means give three 8-dim vectors (paper §III-D).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.convert import autoencoder_params_from_numpy
from repro_torch.core.autoencoder import embed_properties, train_autoencoder
from repro_torch.core.encoding import encode_properties
from repro_torch.dataflow.workloads import JobSpec
from repro_torch.device import DeviceLike, resolve_device

HARDWARE = ["intel xeon 3.3 ghz", 8, 16, "1gb switch"]
SOFTWARE = ["spark 3.1", "kubernetes 1.18.10", "python 3.8.0",
            "hadoop 2.8.3", "scala 2.12.11"]
EXECUTOR = [6, 10240]      # cores, memory MB (Table I)


class ContextEncoder:
    """Fits the auto-encoder once on the property pool, then embeds.

    ``ae_params`` (a dict of arrays in the reference's layout) skips the fit
    and embeds with those weights instead.
    """

    def __init__(self, jobs: Sequence[JobSpec], seed: int = 0, *,
                 device: DeviceLike = "cuda",
                 ae_params: Optional[Mapping] = None):
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        if ae_params is not None:
            self.ae_params = autoencoder_params_from_numpy(ae_params,
                                                           self.device)
            self.ae_loss = float("nan")
        else:
            pool: List = []
            for job in jobs:
                pool += self._u_props(job) + SOFTWARE
                for c in range(job.n_components):
                    for st in job.stages(c):
                        pool += [st.name, 64, 0]
            vecs = encode_properties(pool)
            self.ae_params, self.ae_loss = train_autoencoder(
                vecs, steps=400, device=self.device)
        self._cache: Dict[str, np.ndarray] = {}

    def _u_props(self, job: JobSpec) -> List:
        return ([job.name, job.params, job.dataset.name,
                 int(job.dataset.size_gb)] + HARDWARE + EXECUTOR)

    def _embed(self, props: List) -> np.ndarray:
        key = repr(props)
        if key not in self._cache:
            vecs = encode_properties(props)
            emb = embed_properties(self.ae_params, vecs)
            self._cache[key] = emb.mean(axis=0).astype(np.float32)
        return self._cache[key]

    def node_context(self, job: JobSpec, stage_name: str, n_tasks: int,
                     attempt: int = 0, drop_versions: bool = True
                     ) -> np.ndarray:
        u = self._embed(self._u_props(job))
        # one rng draw per software entry, in list order (the reference's
        # short-circuit draws exactly these; callers depend on the stream)
        sw = [s for s in SOFTWARE
              if not (drop_versions and self.rng.rand() < 0.2)]
        v = self._embed(sw) if sw else np.zeros(8, np.float32)
        w = self._embed([stage_name, int(n_tasks), int(attempt)])
        return np.concatenate([u, v, w]).astype(np.float32)
