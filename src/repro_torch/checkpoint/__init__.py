from .ckpt import load_tree, records_to_tree, save_tree, tree_to_records
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "load_tree", "records_to_tree", "save_tree",
           "tree_to_records"]
