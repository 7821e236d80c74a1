"""Benchmark jobs, simulated cluster, context encoding and run helpers."""
