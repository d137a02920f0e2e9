"""The language-model stack of the port (port of ``repro/models``): every
family's loss (with remat), prefill and decode with KV and state caches,
and the embeddings the index is built over (``models/api.py::Model``).

Dense and MoE decoders, gemma2's local/global pattern, Mamba2 and
zamba2's shared-attention hybrid, xLSTM, and the encoder-decoder.
"""
