from percivaltts_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate_state,
    shard_batch,
)
from percivaltts_tpu_torch.parallel import distributed  # noqa: F401
