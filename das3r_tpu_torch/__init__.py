"""DAS3R in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``das3r_tpu`` (the JAX/Pallas package, which stays the
reference): same module paths, same semantics, PyTorch idiom. The entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; without
CUDA and without a named device they raise ``RuntimeError``.
"""
