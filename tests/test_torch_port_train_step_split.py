"""The tiny training step against JAX's with every block on the two
sublayer kernels on both sides (port ``ROUTE_TRAIN_BLOCK_MAX_C`` at 0, so
each block trains through ``LnWindowAttentionTrainable`` and
``LnMlpTrainable``; JAX ``SUNET_TRAIN_BLOCK_KERNEL=0``, so each block takes
``ln_window_attention_trainable`` and ``ln_mlp_trainable``); see
``test_torch_port_train_step.py`` for the comparison and its tolerance."""

from test_torch_port_train_step import check_step


def test_training_step_on_the_sublayer_kernels_matches_jax(monkeypatch):
    check_step(None, monkeypatch, split=True)
