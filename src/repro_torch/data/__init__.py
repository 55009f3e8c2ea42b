"""Synthetic data of the port (numpy only, byte-identical to the reference's)."""
