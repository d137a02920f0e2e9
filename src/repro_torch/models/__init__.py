"""The language-model backbone of the port: the dense decoder stack that
turns token ids into embeddings for the index (``models/api.py::Model``).

Port of ``repro/models`` for ``family="dense"`` with ``layer_pattern=
"global"``: full-sequence (prefill) forward only. Decode and its KV cache,
logits and losses, MoE, SSM, xLSTM, hybrid and encoder-decoder stacks are
not ported yet (ROADMAP queue 1, item 13).
"""
