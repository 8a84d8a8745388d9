"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro/``), with the
same module names.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  On one GPU it serves a dense decoder (qwen3-8b:
configs, models at tensor-parallel size 1, the symmetric-heap
allocator, the paged KV cache, the FCFS scheduler, the sampler, the
engine), runs the POSH communication library with 8 PEs stacked on one
card (``core``, ``comm``), and trains a dense decoder (gemma-2b,
qwen3-8b: ``parallel``, ``data``, ``train``, ``models.flash``).  Its
kernels are written in CUDA C++ for ``sm_90a``
(``kernels/csrc/``): paged attention, the copy engine, the combine and
the flash-attention forward.

    python -m repro_torch.launch.serve --requests 8
    python -m repro_torch.launch.train --arch gemma-2b --steps 3 \
        --microbatches 8
"""
