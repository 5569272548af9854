"""PyTorch + CUDA port of the ``repro`` package (the JAX reference).

Mirrors ``repro``'s layout — ``kernels/``, ``models/``, ``serve/``,
``core/``, ``configs/``, ``ckpt/``, ``launch/`` — and imports ``torch``
and numpy only: never ``jax``, never ``repro``.  Entry points take an
explicit ``device`` and default to CUDA.
"""
