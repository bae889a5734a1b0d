"""The tiny training step against JAX's with the C=128 stage on plain
autograd on both sides (port ``ROUTE_TRAIN_BLOCK_MAX_C`` and JAX
``SUNET_TRAIN_KERNEL_MAX_C`` at 64); see ``test_torch_port_train_step.py``
for the comparison and its tolerance."""

from test_torch_port_train_step import check_step


def test_training_step_with_wide_stage_on_autograd_matches_jax(monkeypatch):
    check_step(64, monkeypatch)
