"""Distribution (port of `repro.dist`): the mesh context and the
tensor-parallel collectives (`dist.api`), and the path-pattern rule table
that places every parameter and cache leaf (`dist.sharding`)."""
from repro_torch.dist.api import (Mesh, all_gather, all_reduce,
                                  collective_counts, copy_to_model,
                                  current_mesh, dp_axes, gather_from_model,
                                  mesh_axis_sizes, reduce_from_model,
                                  reset_collectives, split_to_model, use_mesh)
from repro_torch.dist.sharding import (batch_spec, cache_spec, fit_spec,
                                       paged_cache_spec, param_spec,
                                       slot_cache_spec)

__all__ = [
    "Mesh", "all_gather", "all_reduce", "batch_spec", "cache_spec",
    "collective_counts", "copy_to_model", "current_mesh", "dp_axes",
    "fit_spec", "gather_from_model", "mesh_axis_sizes", "paged_cache_spec",
    "param_spec", "reduce_from_model", "reset_collectives",
    "slot_cache_spec", "split_to_model", "use_mesh",
]
