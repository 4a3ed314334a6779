"""The port's `synthetic_batch` takes the JAX function's argument order and
defaults: `(cfg, batch_size=1, num_rays=512, seed=0, with_labels=True)`."""

import numpy as np

from preworld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from preworld_tpu.data.synthetic import tiny_config as jax_tiny_config
from preworld_tpu_torch.data import synthetic_batch, tiny_config

LABEL_KEYS = {"voxel_semantics", "mask_camera", "gt_depth", "rays"}


def test_positional_call_matches_jax():
    """`synthetic_batch(cfg, 1, 256, 3)`: 256 rays from seed 3, with labels,
    byte for byte with the JAX function called the same way."""
    got = synthetic_batch(tiny_config(), 1, 256, 3)
    want = jax_synthetic_batch(jax_tiny_config(), 1, 256, 3)
    assert sorted(got) == sorted(want)
    assert got["rays"].shape == (1, 256, 16)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_default_call_has_labels():
    got = synthetic_batch(tiny_config(), 1)
    assert LABEL_KEYS <= set(got)
    assert got["rays"].shape == (1, 512, 16)
    inference = synthetic_batch(tiny_config(), 1, with_labels=False)
    assert not LABEL_KEYS & set(inference)
    for k, v in inference.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
