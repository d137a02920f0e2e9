"""The training runtime of the port (port of ``repro/runtime``)."""
