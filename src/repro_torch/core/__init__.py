"""Enel's model, graphs, training state and decision path (PyTorch)."""
