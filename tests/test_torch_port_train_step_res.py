"""The tiny training step against JAX's default step: no
``SUNET_BWD_RESID`` override and automatic attention layouts, so every one
of the 14 tiny blocks (C=16..128, 2 heads, 16-token windows: all on the
blockdiag layout) trains on the residual route on both sides, the port's
``SwinBlockTrainableRes`` and JAX ``swin_block_trainable_res``; the launch
counts assert it. See ``test_torch_port_train_step.py`` for the comparison
and its tolerance."""

from test_torch_port_train_step import check_step


def test_training_step_on_the_residual_route_matches_jax_default(monkeypatch):
    check_step(None, monkeypatch, resid=True)
