"""The port's counterparts of ``repro``'s kernel benchmarks
(``benchmarks/``), run as modules:

  * ``python -m repro_torch.bench.roofline`` — each kernel's time against
    its roofline bound, at peaks measured on the device;
  * ``python -m repro_torch.bench.buildpath`` — the construction prune by
    level shape and backend (legacy, torch, cuda), and whole builds.

Both run on the card unless ``--device cpu`` is given, and write their
record under ``artifacts/`` only when run as a command.
"""
