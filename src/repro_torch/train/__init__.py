"""Training and serving steps of the port (port of ``repro/train``): the
train step with microbatches and int8 error-feedback compression
(``step.py``), AdamW (``optimizer.py``), the compression itself
(``compression.py``), and the prefill and greedy decode steps."""
