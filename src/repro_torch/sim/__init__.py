"""Scenario engine: seeded disturbance scenarios + vectorized fleet simulation.

Import layering (to keep ``repro_torch.dataflow.simulator`` importable on
its own): this package ``__init__`` only pulls in the leaf modules
(``tables``, ``scenarios``); the vectorized engine lives in
``repro_torch.sim.engine`` (it imports the dataflow record types) and the
evaluation harness in ``repro_torch.sim.evaluate``; import those
explicitly.
"""
from repro_torch.sim.scenarios import (BASELINE, SCENARIO_NAMES, Scenario,
                                       make_scenario)

__all__ = ["BASELINE", "SCENARIO_NAMES", "Scenario", "make_scenario"]
