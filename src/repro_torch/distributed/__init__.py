"""The sharded cache: a key-sharded vector store over a device mesh and the
collective read path that serves a hierarchy from it."""
from repro_torch.distributed.sharding import (  # noqa: F401
    BATCH,
    FSDP,
    SEQ,
    TP,
    is_spec_leaf,
    mesh_num_devices,
    resolve_spec,
)
