"""The smoke cells on the card, through the CUDA kernels: skipped where
there is no GPU (decided in the fixture, at run time)."""
import pytest
import torch

from perfbench import harness
from perfbench.lib import tiny


@pytest.fixture(scope="module")
def cuda_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the smoke cells run the port's "
                    "CUDA kernels")
    return tiny.make(tmp_path_factory.mktemp("card"))


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.moe", "tiny.train",
                                  "tiny.rma"])
def test_smoke_cell_on_the_card(cuda_root, cell):
    out = harness.run_cell(cell, 2 ** 31 + 29, 0.5, True, device="cuda",
                           root=cuda_root, bench_dir=cuda_root / "perfbench")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
