"""The port's murmur64 and selection cut against the JAX package's.

Every quantity is an integer, so every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from metamdbg_tpu.utils import hashing as jhashing
from metamdbg_tpu.utils import u64pair
from metamdbg_tpu_torch.utils import hashing

_EDGE_KEYS = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
              (1 << 64) - 1]


def _to_torch(u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u64, np.uint64)
                            .view(np.int64))


def _to_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_murmur64_matches_jax_package():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 64, size=100_000, dtype=np.uint64,
                        endpoint=False)
    keys = np.concatenate([np.array(_EDGE_KEYS, np.uint64), keys])
    got = _to_u64(hashing.murmur64_u64key(_to_torch(keys), seed=42))
    want = jhashing.murmur64_u64key(keys, seed=42)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 42, (1 << 64) - 1])
def test_murmur64_seeds(seed):
    keys = np.array(_EDGE_KEYS, np.uint64)
    got = _to_u64(hashing.murmur64_u64key(_to_torch(keys), seed=seed))
    np.testing.assert_array_equal(got, jhashing.murmur64_u64key(keys,
                                                                seed=seed))


@pytest.mark.parametrize("density", [0.005, 0.025, 0.02, 0.05, 0.1])
def test_threshold_matches_u64pair(density):
    assert hashing._exact_u64_threshold(density) == \
        u64pair._exact_u64_threshold(density)


def test_u64_lt_is_unsigned():
    rng = np.random.default_rng(12)
    x = np.concatenate([np.array(_EDGE_KEYS, np.uint64),
                        rng.integers(0, 1 << 64, size=10_000,
                                     dtype=np.uint64)])
    for t in [0, 1, 1 << 32, 1 << 63, (1 << 63) + 5, (1 << 64) - 1,
              1 << 64, u64pair._exact_u64_threshold(0.005)]:
        got = hashing.u64_lt(_to_torch(x), t).numpy()
        want = np.array([int(v) < t for v in x.tolist()])
        np.testing.assert_array_equal(got, want, err_msg=f"t={t}")


@pytest.mark.parametrize("density", [0.005, 0.025])
def test_selection_matches_jax_package(density):
    rng = np.random.default_rng(13)
    vals = rng.integers(0, 1 << 32, size=200_000, dtype=np.uint64)
    got = hashing.minimizer_is_selected(_to_torch(vals), density).numpy()
    want = jhashing.minimizer_is_selected(vals, density)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
