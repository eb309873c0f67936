from llzlab_tpu_torch.chains.channelizer import Channelizer  # noqa: F401
