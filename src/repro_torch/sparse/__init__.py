"""Redundancy-aware adapter pruning and shared-w serving (port of
`repro.sparse`): layer masks and importance (`importance`), packed sparse
deltas and the paper's 0.022 % preset (`prune`), and the shared-w /
per-task-b factorization of the bank (`shared`). The serving bank unpacks
pruned tenants at insert and gates their rows off in the masked
multitask kernel (`kernels/sparse.py`)."""
from repro_torch.sparse.importance import (ablate_layers,
                                           ablation_importance,
                                           apply_layer_mask,
                                           cross_task_importance, depth_mask,
                                           gated_param_count, leaf_layer_ids,
                                           magnitude_importance, mask_gate,
                                           n_layers, topk_mask)
from repro_torch.sparse.prune import (PRESETS, PackedRows, delta_mask,
                                      is_packed, pack_delta, pack_leaf,
                                      packed_bytes, preset_mask, prune_delta,
                                      search_mask, sparse_param_stats,
                                      unpack_delta,
                                      unpack_leaf)
from repro_torch.sparse.shared import (SharedAdapter, bank_bytes_report,
                                       factorize, from_vectors, load_shared,
                                       save_shared, shared_w_overlay, task_row)

__all__ = [
    "PRESETS", "PackedRows", "SharedAdapter", "ablate_layers",
    "ablation_importance", "apply_layer_mask",
    "bank_bytes_report", "cross_task_importance", "delta_mask", "depth_mask",
    "factorize", "from_vectors", "gated_param_count", "is_packed",
    "leaf_layer_ids", "load_shared", "magnitude_importance", "mask_gate",
    "n_layers", "pack_delta", "pack_leaf", "packed_bytes", "preset_mask",
    "prune_delta", "save_shared", "search_mask", "shared_w_overlay",
    "sparse_param_stats",
    "task_row", "topk_mask", "unpack_delta", "unpack_leaf",
]
