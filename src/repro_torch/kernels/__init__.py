"""Hand-written Hopper kernels of the port and their dispatch.

kernels/<name>.py — the ctypes wrapper of csrc/<name>.cu, with a launch
                    counter and its plain version beside it
kernels/_build.py — nvcc at first use, cached by source hash
kernels/ops.py    — impl dispatch ("auto" | "cuda" | "torch" [| "composed"])
kernels/ref.py    — the plain torch versions (the correctness contract)
"""
from repro_torch.kernels import ops

__all__ = ["ops"]
