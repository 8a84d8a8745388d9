"""The parameter-tree helpers under the training package's name (they
live in ``repro_torch.tree``, which the comm layer imports too)."""
from repro_torch.tree import (describe, leaves, ref_groups, ref_tree,
                              tree_map, unflatten)

__all__ = ["describe", "leaves", "ref_groups", "ref_tree", "tree_map",
           "unflatten"]
