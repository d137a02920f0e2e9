"""Checkpoints of the port (port of ``repro/checkpoint``)."""
