"""PyTorch/CUDA port of the NeCTAr serving stack (the JAX package ``repro``
is the reference it is held against).

Layout mirrors ``repro`` module for module:
  configs/  config dataclasses (own copy) + the nectar registry
  core/     activation sparsity (top-k gathered down-projection)
  kernels/  hand-written CUDA kernels for Hopper (csrc/*.cu), their plain
            PyTorch versions (ref.py), the nvcc build and the dispatch
  models/   the decoder stack's paged serving step
  serve/    paged engine: scheduler, block pool, runner, streaming API

Device policy: every entry point takes ``device`` and defaults to CUDA;
without a card it raises and asks for ``device="cpu"``. Nothing falls
back to the CPU on its own.
"""

__version__ = "0.1.0"
