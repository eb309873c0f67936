from llzlab_tpu_torch.parallel.mesh import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    TIME_MAJOR,
    CHANNEL_MAJOR,
    DspMesh,
    make_dsp_mesh,
    channel_time_spec,
    shard,
    gather,
    shard_time,
    gather_time,
)
from llzlab_tpu_torch.parallel.halo import (  # noqa: F401
    left_halo,
    broadcast_from_last,
)
# (the function ``reshard`` stays in its module: the package attribute of
# that name is the module)
from llzlab_tpu_torch.parallel.reshard import (  # noqa: F401
    to_channel_major,
    to_time_major,
)
from llzlab_tpu_torch.parallel.sharded_ops import (  # noqa: F401
    fir_filter_sharded,
    resample_sharded,
    sosfilt_sharded,
    fft_frames_sharded,
)
from llzlab_tpu_torch.parallel.spectral_sp import (  # noqa: F401
    spectral_gain_sharded,
)
from llzlab_tpu_torch.parallel.tap_tp import (  # noqa: F401
    fir_filter_tap_parallel,
)
from llzlab_tpu_torch.parallel.stage_pp import (  # noqa: F401
    make_stage_mesh,
    stage_pipeline,
)
