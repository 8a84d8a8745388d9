"""Hand-written Hopper kernels, their plain PyTorch versions and
wrappers (``paged_attention``, ``flash_attention``, ``symm_copy``,
``reduce_combine``), the
nvcc build (``build``) and the public entry points (``ops``)."""
