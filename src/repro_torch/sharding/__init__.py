"""Parameter definitions of the port (``repro/sharding`` without a mesh)."""
