"""Deterministic synthetic token stream of the port (counterpart of
``repro.data``)."""
