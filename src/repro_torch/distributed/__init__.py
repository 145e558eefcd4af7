"""The sharded cache: a key-sharded vector store over a device mesh and the
collective read path that serves a hierarchy from it; and the sharding
rules, placement and mesh context the model and the dry run read."""
from repro_torch.distributed.sharding import (  # noqa: F401
    BATCH,
    FSDP,
    SEQ,
    TP,
    NamedSharding,
    constrain,
    current_mesh,
    device_put_tree,
    is_spec_leaf,
    mesh_num_devices,
    named_sharding,
    resolve_spec,
    shardings_for,
    use_mesh,
)
