"""Multi-device runs: device meshes, frame data-parallelism, width sharding.

The reference's only parallelism is host-side frame MT (MT_MULTI_INSTANCE,
reference src/SangNom2.h:63-66) plus SSE2 lanes.  Here:

- frames -> data parallelism over a mesh axis (no communication);
- width  -> column shards with halo exchange (rows cannot shard: the
            vertical smoothing recursion, SURVEY.md §2 quirk 1); on one
            device the shards run as more blocks of the K4/K5 kernels,
            across the devices of one process each shard runs its own
            launches and copies halos device to device (`cross_device`);
- processes -> frame shards over ``torch.distributed`` (`multihost`), one
            all-gather of frame counts a call.
"""

from sangnom_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_distributed,
    multihost_mesh,
    sangnom2_multihost,
)
from sangnom_tpu_torch.parallel.sharding import (  # noqa: F401
    default_mesh,
    sangnom2_sharded,
)
