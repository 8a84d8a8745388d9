"""Hand-written Hopper kernels, their plain PyTorch versions and
wrappers (``paged_attention``), the nvcc build (``build``) and the
public entry points (``ops``)."""
