"""Simulator cost tables and seeded disturbance scenarios (numpy)."""
