from sunet_tf_tpu_torch.infer.export import (  # noqa: F401
    ServingModel,
    TiledServingModel,
    export_forward,
    export_tiled,
    save_exported,
    save_exported_tiled,
)
from sunet_tf_tpu_torch.infer.tiled import (  # noqa: F401
    TiledRunner,
    padded_inference,
    required_granularity,
    tiled_inference,
)
