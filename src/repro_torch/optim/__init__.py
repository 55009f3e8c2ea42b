"""Optimizers of the port: AdamW (32- or 8-bit state) and LR schedules."""
