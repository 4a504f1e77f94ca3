"""Checkpoints of the port: the JAX package's msgpack file format
(`store`) and the step-directory manager over it (`manager`)."""
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import load_tree, save_tree

__all__ = ["CheckpointManager", "load_tree", "save_tree"]
