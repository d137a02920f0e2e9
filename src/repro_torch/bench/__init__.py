"""The port's counterparts of ``repro``'s kernel benchmarks
(``benchmarks/``), run as modules:

  * ``python -m repro_torch.bench.roofline`` — each kernel's time against
    its roofline bound, at peaks measured on the device;
  * ``python -m repro_torch.bench.buildpath`` — the construction prune by
    level shape and backend (legacy, torch, cuda), and whole builds;
  * ``python -m repro_torch.bench.serve_slo`` — the async serving loop
    under open-loop Poisson load (nominal, overload, chaos legs);
  * ``python -m repro_torch.bench.run`` — the paper's figure and table
    scripts (``fig*.py``, ``table*.py``, ``scalability.py``).

Each runs on the card unless ``--device cpu`` is given, and writes its
record under ``artifacts/`` only when run as a command.
"""
