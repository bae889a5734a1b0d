from sunet_tf_tpu_torch.infer.tiled import (  # noqa: F401
    TiledRunner,
    padded_inference,
    required_granularity,
    tiled_inference,
)
