"""PyTorch/CUDA port of the NeCTAr serving stack (the JAX package ``repro``
is the reference it is held against).

Layout mirrors ``repro`` module for module:
  configs/  config dataclasses (own copy) + the registry (nectar,
            llama3.2-1b, granite-34b)
  core/     activation sparsity, int8 quantization, the NMCE matmul
  kernels/  hand-written CUDA kernels for Hopper (csrc/*.cu), their plain
            PyTorch versions (ref.py), the nvcc build and the dispatch
  models/   the decoder stack: slot cache and paged serving step
  serve/    the engines: scheduler, refcounted block pool, radix prefix
            cache, runner, sampler (threefry draws in prng.py), metrics,
            streaming API
  launch/   the serve CLI (python -m repro_torch.launch.serve)

Device policy: every entry point takes ``device`` and defaults to CUDA;
without a card it raises and asks for ``device="cpu"``. Nothing falls
back to the CPU on its own.
"""

__version__ = "0.1.0"
