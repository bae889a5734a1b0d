from sunet_tf_tpu_torch.kernels.window_attention import fused_window_attention  # noqa: F401
