"""The step builders of the port (port of ``repro/train``): the serving
steps for now; the training step, the optimizer and gradient compression
wait (ROADMAP queue 1 item 13b)."""
