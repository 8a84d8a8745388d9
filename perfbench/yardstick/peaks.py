"""NVIDIA H100 SXM5 peaks (NVIDIA's data sheet, dense, at 700 W): the
rates every roofline share and mfu of this benchmark divides by.  A copy
frozen here, so that no change to the program can move the yardstick
(the program's own table is ``repro_torch.launch.roofline``)."""

HBM_BYTES_S = 3.35e12
FLOPS = {"bfloat16": 989e12,            # tensor cores
         "tf32": 495e12,                # tensor cores
         "float32": 67e12}              # CUDA cores, TF32 off


def matmul_peak(dtype: str, tf32: bool) -> float:
    """The peak of the precision f32 / bf16 matrix products run in."""
    if dtype == "float32" and tf32:
        return FLOPS["tf32"]
    return FLOPS[dtype]
