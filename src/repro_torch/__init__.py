"""PyTorch/CUDA port of the SHiRA serving system (``src/repro`` is the JAX
reference). Layout mirrors ``repro``: configs, models, kernels (hand-written
CUDA for Hopper under ``kernels/csrc``), core, serving, launch, plus
``bridge`` for crossing JAX weights over through numpy."""
