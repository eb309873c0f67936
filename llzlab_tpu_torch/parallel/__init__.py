from llzlab_tpu_torch.parallel.mesh import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    DspMesh,
    make_dsp_mesh,
    shard_time,
    gather_time,
)
from llzlab_tpu_torch.parallel.halo import (  # noqa: F401
    left_halo,
    broadcast_from_last,
)
