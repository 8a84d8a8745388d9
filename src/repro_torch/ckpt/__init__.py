"""repro_torch.ckpt — checkpoints with integrity hashes, in the
reference's on-disk layout, and the weight hot-swap: a new parameter
generation streamed into a live serving engine between ticks
(put-with-signal batches, an atomic generation flip, no global drain).
The counterpart of ``repro.ckpt``."""
from .checkpoint import Checkpointer, load_checkpoint, save_checkpoint
from .hotswap import WeightStreamer

__all__ = ["Checkpointer", "save_checkpoint", "load_checkpoint",
           "WeightStreamer"]
