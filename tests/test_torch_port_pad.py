"""The port's reflect pad and padded inference held against the JAX
package's (sunet_tf_tpu/infer/tiled.py), on the CPU, with no model.

The same numpy inputs from a seed go to both; pads below, equal to and
several times the image side (a pad past the side reflects again, as
``jnp.pad(mode="reflect")`` does; a side of 1 repeats its row). Exact
equality: both sides only gather elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunet_tf_tpu.infer import tiled as jtiled
from sunet_tf_tpu_torch.infer import tiled as ttiled


@pytest.mark.parametrize("hw,pads", [
    ((5, 7), (3, 6)),       # below the side
    ((5, 7), (5, 7)),       # equal to it
    ((5, 5), (11, 59)),     # 5 px to 16 and to 64
    ((1, 3), (4, 9)),       # a side of 1
    ((2, 9), (0, 40)),
])
def test_reflect_pad_equals_jax(hw, pads):
    x = np.random.default_rng(0).random((2, *hw, 3), np.float32)
    got = ttiled.reflect_pad_nhwc(torch.from_numpy(x), *pads)
    want = np.asarray(jtiled.reflect_pad_nhwc(jnp.asarray(x), *pads))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,gran", [((5, 5), 16), ((5, 5), 64), ((13, 6), 8),
                                     ((1, 4), 8)])
def test_padded_inference_equals_jax(hw, gran):
    x = np.random.default_rng(1).random((1, *hw, 2), np.float32)
    # one elementwise model for both sides; it reads the padded map's
    # height, so the crop is checked as well
    def fn(y):
        return y * 2.0 - 1.0 + y.shape[1] * 1e-3

    got = ttiled.padded_inference(fn, torch.from_numpy(x), gran)
    want = np.asarray(jtiled.padded_inference(fn, jnp.asarray(x), gran))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
