"""Model functions of the port (dense family, tensor-parallel size 1)."""
