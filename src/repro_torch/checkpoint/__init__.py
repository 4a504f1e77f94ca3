"""Checkpoints of the port: the JAX package's msgpack file format
(`store`), the step-directory manager over it (`manager`), and
`restore_into`, which overlays a loaded snapshot onto a skeleton."""
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import load_tree, save_tree
from repro_torch.common import tree as tu


def restore_into(skeleton, restored_tree):
    """Overlay a loaded checkpoint onto a skeleton by path, as JAX's
    `restore_into`: a new tree of the skeleton's structure whose tensor
    leaves the checkpoint holds are the checkpoint's, cast to the
    skeleton leaf's dtype and moved to its device (host tensors from the
    store onto the card); every other leaf is the skeleton's."""
    flat = dict(tu.flatten_with_paths(restored_tree))

    def pick(path, v):
        t = flat.get(path)
        if t is None or not torch.is_tensor(v):
            return v
        return t.to(device=v.device, dtype=v.dtype)

    return tu.map_with_path(pick, skeleton)


__all__ = ["CheckpointManager", "load_tree", "restore_into", "save_tree"]
