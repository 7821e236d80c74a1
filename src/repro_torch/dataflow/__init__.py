"""Benchmark jobs, simulated cluster, context encoding, the experiment
runner and fleet campaigns (PyTorch port of ``repro.dataflow``).  Nothing
here touches a card at import time."""
from repro_torch.dataflow.context import ContextEncoder
from repro_torch.dataflow.fleet import FleetCampaign
from repro_torch.dataflow.runner import JobExperiment, RunStats, window_stats
from repro_torch.dataflow.simulator import (ClusterSim, RunRecord,
                                            rescale_overhead)
from repro_torch.dataflow.workloads import (DATASETS, JOBS, SCALEOUT_RANGE,
                                            JobSpec, StageSpec, scale_job)

__all__ = ["ClusterSim", "ContextEncoder", "DATASETS", "FleetCampaign",
           "JOBS", "JobExperiment", "JobSpec", "RunRecord", "RunStats",
           "SCALEOUT_RANGE", "StageSpec", "rescale_overhead", "scale_job",
           "window_stats"]
