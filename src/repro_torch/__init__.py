"""PyTorch/CUDA port of the throughput engines in ``repro``.

``repro_torch.core`` holds the dual-engine main path (graphs, traffic, LP
oracle, APSP backends, dual descent, BatchPlan, engines);
``repro_torch.kernels`` holds the hand-written CUDA kernels for Hopper
(``csrc/*.cu``, built with nvcc on first use) beside their plain torch
versions.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.  The package imports neither jax nor ``repro``.
"""
