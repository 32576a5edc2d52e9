"""PyTorch / CUDA port of the SEAL serving system.

Mirrors ``src/repro/`` file for file: each module names the JAX module it
ports in its docstring, and the JAX package stays the reference the port is
held against. The port imports ``torch`` and never ``jax`` or ``repro``.

Entry points take an explicit ``device``: they run on ``cuda`` and raise when
no card is present, unless the caller passes ``device="cpu"`` (the tests do).
"""
