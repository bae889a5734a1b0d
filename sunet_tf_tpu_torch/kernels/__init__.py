from sunet_tf_tpu_torch.kernels.window_attention import fused_window_attention  # noqa: F401
from sunet_tf_tpu_torch.kernels import ops  # noqa: F401,E402  (registers the sunet:: ops)
