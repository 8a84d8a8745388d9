"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro/``), with the
same module names.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  This slice serves a dense decoder (qwen3-8b) on
one GPU: configs, models at tensor-parallel size 1, the symmetric-heap
allocator, the paged KV cache, the FCFS scheduler, the sampler, the
engine, and the two paged-attention kernels written in CUDA C++ for
``sm_90a`` (``kernels/csrc/paged_attention.cu``).

    python -m repro_torch.launch.serve --requests 8
"""
