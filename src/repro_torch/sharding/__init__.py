"""Sharding rules of the port (the port of ``repro.sharding``)."""
