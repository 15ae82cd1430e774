"""Optimizers on parameter trees (the port of ``repro.optim``)."""
