"""One whole training step of the shrunk scaled SUNet (``test_torch_port_scaled.py``'s
``SHRUNK``: 128x128, EMB 60, heads 2/4/8/16, depth 2) in the port against
the JAX package's, through ``test_torch_port_train_step.check_step``
(loss relative 1e-5, every gradient max |diff| <= 2e-3 * max|ref| + 1e-7).

The port runs its fused route on the CPU (the kernels' plain versions): the
8 blocks at 256-token windows (C=60 and 120) on #1's train form and #8's
big-window backward, the C=240 and C=480 blocks (64 and 16 tokens a
window; C=240's 8 heads give the cluster block kernel no plan, C=480 is
above its cap) on #1's train form on the sequence form and #8, as JAX's
block kernel takes every block up to C=768; the head on #5 + #9 at C=60. JAX runs ``value_and_grad`` of the same loss on its XLA
attention backend (``attention_backend="xla"``): its Pallas training
kernels in interpret mode take minutes for this step on one CPU core;
``test_torch_port_scaled_train.py`` holds the block and head kernels' plain
versions against those Pallas kernels one by one.
"""

from test_torch_port_scaled import SHRUNK
from test_torch_port_train_step import check_step

from sunet_tf_tpu import config as jconfig
from sunet_tf_tpu_torch import config as tconfig


def test_scaled_training_step_matches_jax(monkeypatch):
    configs = (jconfig.scaled_config(**SHRUNK), tconfig.scaled_config(**SHRUNK))
    check_step(None, monkeypatch, configs=configs, routes=(14, 0), jax_backend="xla")
