"""The port's threefry PRNG is bit-exact with ``jax.random`` (threefry2x32,
partitionable): keys, fold_in, split, uniform and randint over several
seeds, shapes and key batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def tk(key) -> torch.Tensor:
    return torch.from_numpy(kd(key))


SEEDS = [0, 1, 42, 2**31 - 1, -3]
SHAPES = [(), (1,), (3,), (3, 4), (2, 3, 5)]


def test_reference_prng_config():
    """The port reproduces this PRNG configuration of the reference."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(prng.key(seed, "cpu").numpy(), kd(k))
    for d in (0, 1, 2, 3, 12345, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk(k), d).numpy(),
                                      kd(jax.random.fold_in(k, d)))
    # batched fold_in over instance ids, as the sweep's init does
    ids = jnp.arange(37)
    want = kd(jax.vmap(lambda i: jax.random.fold_in(k, i))(ids))
    got = prng.fold_in(tk(k), torch.arange(37))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 4, 5, 6])
def test_split(seed, num):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(prng.split(tk(k), num).numpy(),
                                  kd(jax.random.split(k, num)))
    keys = jax.random.split(jax.random.key(seed + 7), 4)
    want = kd(jax.vmap(lambda kk: jax.random.split(kk, num))(keys))
    np.testing.assert_array_equal(prng.split(tk(keys), num).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.15, 0.55), (26.0, 33.0),
                                    (0.85, 1.15), (20.0, 45.0)])
def test_uniform(seed, shape, bounds):
    k = jax.random.key(seed)
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    got = prng.uniform(tk(k), shape, lo, hi).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(0, 2**31 - 1), (-5, 17), (0, 4), (3, 3)])
def test_randint(seed, shape, bounds):
    k = jax.random.key(seed)
    lo, hi = bounds
    want = np.asarray(jax.random.randint(k, shape, lo, hi))
    got = prng.randint(tk(k), shape, lo, hi).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batched_draws_match_vmap():
    keys = jax.random.split(jax.random.key(11), 6)
    want_u = np.asarray(jax.vmap(
        lambda kk: jax.random.uniform(kk, (3, 4), minval=0.85, maxval=1.15)
    )(keys))
    np.testing.assert_array_equal(
        prng.uniform(tk(keys), (3, 4), 0.85, 1.15).numpy(), want_u)
    want_i = np.asarray(jax.vmap(
        lambda kk: jax.random.randint(kk, (), 0, 2**31 - 1))(keys))
    np.testing.assert_array_equal(
        prng.randint(tk(keys), (), 0, 2**31 - 1).numpy(), want_i)
