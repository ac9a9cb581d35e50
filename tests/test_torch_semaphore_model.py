"""The CUDA admission kernel's algorithm, modelled on the CPU
(``semaphore_admission_model``: lanes of sorted register slots, or
above 1024 slots a column per lane, order-preserving integer keys and
the first tied lane), held bit-equal to the JAX package's Pallas kernel
(interpret mode) and its ``lax.scan`` oracle on grant, release and
waited.

The kernel replaces *a* slot holding the minimum, not the reference's
lowest-index one; only the minimum's value reaches an output, so the
tolerance is bit equality. Traces include the engine's tie-heavy shape,
K > N, the K values where a lane's slots grow (32, 33, 64) and K 1024.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.semaphore.kernel import sleeping_semaphore_pallas
from repro.kernels.semaphore.ref import sleeping_semaphore_ref
from repro_torch.kernels import semaphore as tsem


def _trace(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":   # the engine's shape: in-flight holds arrive "now"
        arr = np.concatenate([np.zeros(n // 2), 1e-3 * (np.arange(
            n - n // 2) + 1)]).astype(np.float32)
        hold = rng.integers(1, 9, n).astype(np.float32)
    elif kind == "equal":  # every arrival and hold equal: ties everywhere
        arr = np.ones(n, np.float32)
        hold = np.full(n, 2.0, np.float32)
    else:
        arr = np.cumsum(rng.exponential(1.0, n)).astype(np.float32)
        hold = rng.uniform(0.5, 20.0, n).astype(np.float32)
    return arr, hold


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


CASES = [(n, k) for n in (1, 7, 40) for k in (1, 2, 3, 4, 8, 9, 32, 33, 64)]
CASES += [(40, 1024), (5, 1024), (64, 100)]


@pytest.mark.parametrize("n,capacity", CASES)
@pytest.mark.parametrize("kind", ["random", "ties", "equal"])
def test_model_bit_equal_to_pallas_and_ref(n, capacity, kind):
    arr, hold = _trace(n * 31 + capacity, n, kind)
    got = tsem.semaphore_admission_model(arr, hold, capacity)
    a, h = jnp.asarray(arr), jnp.asarray(hold)
    for want in (sleeping_semaphore_pallas(a, h, capacity, interpret=True),
                 sleeping_semaphore_ref(a, h, capacity)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("capacity", [3, 33])
def test_model_handles_negative_holds(capacity):
    """A release earlier than the slot it replaces: the network inserts
    it below the other slots, as the reference's replacement does."""
    rng = np.random.default_rng(capacity)
    arr = np.cumsum(rng.exponential(1.0, 50)).astype(np.float32)
    hold = rng.uniform(-3.0, 5.0, 50).astype(np.float32)
    got = tsem.semaphore_admission_model(arr, hold, capacity)
    want = sleeping_semaphore_ref(jnp.asarray(arr), jnp.asarray(hold),
                                  capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_model_equals_plain_version_on_a_long_trace():
    arr, hold = _trace(5, 300, "random")
    got = tsem.semaphore_admission_model(arr, hold, 17)
    want = tsem.semaphore_admission_plain(torch.from_numpy(arr),
                                          torch.from_numpy(hold), 17)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w.numpy()))


def test_model_rejects_capacity_out_of_range():
    """K 0 is refused; K past the register layout takes the column
    kernel's model, which plans like the reference."""
    z = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="capacity"):
        tsem.semaphore_admission_model(z, z, 0)
    cap = tsem.REGISTER_CAPACITY + 1
    arr, hold = _saturating(cap, cap + 150)
    want = sleeping_semaphore_ref(jnp.asarray(arr), jnp.asarray(hold), cap)
    got = tsem.semaphore_admission_model(arr, hold, cap)
    assert int(got[2].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _saturating(seed, n):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(0.0, 0.5, n)).astype(np.float32),
            rng.integers(1, 9, n).astype(np.float32))


@pytest.mark.parametrize("capacity", [1025, 1100, 2048])
def test_column_model_equals_plain_version(capacity):
    """Columns of ceil(K / 32) slots per lane (33, 35 and 64 wide; the
    last lane's column short at K 1025 and 1100), with waits."""
    arr, hold = _saturating(capacity, capacity + 400)
    got = tsem.semaphore_admission_model(arr, hold, capacity)
    want = tsem.semaphore_admission_plain(torch.from_numpy(arr),
                                          torch.from_numpy(hold), capacity)
    assert int(got[2].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w.numpy()))
