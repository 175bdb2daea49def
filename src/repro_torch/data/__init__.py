"""Synthetic data of the port (a copy of the reference's corpus)."""
