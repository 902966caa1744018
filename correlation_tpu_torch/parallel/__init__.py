from correlation_tpu_torch.parallel.collectives import (
    PIXEL_AXIS,
    assemble_pixel_sharded,
    make_pixel_mesh,
)
from correlation_tpu_torch.parallel.mesh import (
    SUBSET_AXIS,
    Mesh,
    gather_rows,
    init_distributed,
    make_mesh,
    pad_to_mesh,
    replicate,
    shard_inputs,
)

__all__ = [
    "SUBSET_AXIS",
    "make_mesh",
    "pad_to_mesh",
    "shard_inputs",
    "Mesh",
    "init_distributed",
    "replicate",
    "gather_rows",
    "PIXEL_AXIS",
    "make_pixel_mesh",
    "assemble_pixel_sharded",
]
