"""The port's threefry RNG against jax.random, bit for bit.

Every later port-vs-JAX comparison feeds both packages the same random
streams, which is what makes them per pixel rather than statistical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_tpu.core import rng as jrng
from ba_pathtracing_fur_torch.core import rng

torch.set_num_threads(2)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_key_data(seed):
    want = _u32(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(rng.key(seed, "cpu").numpy(), want)


@pytest.mark.parametrize("sample", [0, 1, 37])
def test_keys_for_pixels_bit_exact(sample):
    ids = np.random.default_rng(sample).integers(0, 1 << 20, size=300)
    want = _u32(jax.random.key_data(
        jrng.keys_for_pixels(jax.random.key(0), jnp.asarray(ids), sample)))
    got = rng.keys_for_pixels(rng.key(0, "cpu"), torch.from_numpy(ids), sample).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bounce", [-1, 0, 1, 2, 3, 4, 5])
def test_bounce_uniform_bit_exact(bounce):
    ids = np.arange(200)
    jkeys = jrng.keys_for_pixels(jax.random.key(3), jnp.asarray(ids), 2)
    keys = rng.keys_for_pixels(rng.key(3, "cpu"), torch.from_numpy(ids), 2)
    for tag in range(9):
        for n in (1, 2):
            want = np.asarray(jrng.bounce_uniform(jkeys, bounce, n, tag=tag))
            got = rng.bounce_uniform(keys, bounce, n, tag=tag).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"tag {tag} n {n}")


def test_bounce_uniforms_is_the_stacked_draws():
    keys = rng.keys_for_pixels(rng.key(5, "cpu"), torch.arange(100), 4)
    batched = rng.bounce_uniforms(keys, 2, 5, 2)
    for tag in range(5):
        assert torch.equal(batched[tag], rng.bounce_uniform(keys, 2, 2, tag=tag))
        assert torch.equal(batched[tag, :, :1], rng.bounce_uniform(keys, 2, 1, tag=tag))


@pytest.mark.parametrize("sample,spp", [(0, 1), (3, 16), (99, 100)])
def test_qmc_jitter_bit_exact(sample, spp):
    ids = np.arange(0, 4000, 13)
    want = np.asarray(jrng.qmc_jitter(jax.random.key(0), jnp.asarray(ids), sample, spp))
    got = rng.qmc_jitter(rng.key(0, "cpu"), torch.from_numpy(ids), sample, spp).numpy()
    np.testing.assert_array_equal(got, want)


def test_radical_inverse_bit_exact():
    bits = np.random.default_rng(0).integers(0, 1 << 32, size=1000, dtype=np.uint64)
    want = np.asarray(jrng.radical_inverse_vdc(jnp.asarray(bits.astype(np.uint32))))
    got = rng.radical_inverse_vdc(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
