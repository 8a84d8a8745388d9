"""posh_micro — the paper's own 'architecture': the communication
microbenchmark configuration behind Tables 1–3 (buffer-size sweeps for
put / get / collectives), the port's copy of
``repro.configs.posh_micro``.  Not an LM: ``registry.build``, the
weights helpers and the launchers refuse it by family;
``examples/torch/shmem_pingpong.py`` runs it.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PoshMicroConfig:
    name: str = "posh-micro"
    family: str = "micro"
    buffer_sizes: tuple = tuple(4 ** i for i in range(2, 12))  # 16 .. 4 Mi elems
    dtypes: tuple = ("float32", "bfloat16", "int32")
    repeats: int = 20            # paper: 20 reps after warm-up
    warmup: int = 3


def config() -> PoshMicroConfig:
    return PoshMicroConfig()


def smoke_config() -> PoshMicroConfig:
    return PoshMicroConfig(buffer_sizes=(16, 256), repeats=2, warmup=1)
