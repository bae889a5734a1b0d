"""SUNet on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``sunet_tf_tpu`` (JAX, TPU), which stays the reference. This
package imports torch and never JAX. Kernels are hand-written CUDA in
``kernels/csrc``, built with nvcc at their first CUDA call.

    from sunet_tf_tpu_torch.config import Config
    from sunet_tf_tpu_torch.models.sunet import build_model
    model = build_model(Config(), device="cuda", backend="fused", seed=0)
    y = model(x)   # x: (B, H, W, 3) in [0, 1], NHWC

Training: ``model(x, generator=g)`` is the training forward (parameters
requiring grad; ``train/``), or ``python -m sunet_tf_tpu_torch.train``.
"""
