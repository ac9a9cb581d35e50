"""The CUDA ticket-lock kernel's schedule, modelled on the CPU
(``ticket_lock_schedule_model``: requester slots that each own every
P-th requester, stepped in seeded interleavings), held to the JAX
package's Pallas kernel (interpret mode) and its oracle.

The model asserts on every step that no slot waits on a word only it
could move and that tickets follow the arrival order. Grant order and
turn trace are exact; the chain is bit-equal to the port's plain
float32 fold and within the reference's own tolerance of the Pallas
kernel (rtol 2e-4, atol 1e-4: tests/test_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ticket_lock.kernel import ticket_lock_pallas
from repro.kernels.ticket_lock.ref import ticket_lock_ref
from repro_torch.kernels import ticket_lock as ttl

TOL = dict(rtol=2e-4, atol=1e-4)


def _trace(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.permutation(n).astype(np.int32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("n,slots", [(1, 1), (9, 1), (9, 2), (33, 32),
                                     (40, 3), (64, 32), (64, 7)])
@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_pallas_and_oracle(n, slots, seed):
    arr, m, b = _trace(seed * 1000 + n * 10 + slots, n)
    grant, trace, acc = ttl.ticket_lock_schedule_model(arr, m, b, slots,
                                                       seed=seed)
    for want in (ticket_lock_pallas(jnp.asarray(arr), jnp.asarray(m),
                                    jnp.asarray(b), interpret=True),
                 ticket_lock_ref(jnp.asarray(arr), jnp.asarray(m),
                                 jnp.asarray(b))):
        np.testing.assert_array_equal(grant, np.asarray(want[0]))
        np.testing.assert_array_equal(trace, np.asarray(want[1]))
        np.testing.assert_allclose(float(acc), float(want[2]), **TOL)


@pytest.mark.parametrize("n,slots", [(100, 1), (300, 32), (1000, 64),
                                     (257, 256)])
def test_model_bit_equal_to_plain_when_slots_are_fewer(n, slots):
    """Fewer slots than requesters (the kernel's N > block size): each
    slot serves several requesters in order without deadlock, and the
    chain is the float32 fold bit for bit."""
    arr, m, b = _trace(n + slots, n)
    grant, trace, acc = ttl.ticket_lock_schedule_model(arr, m, b, slots,
                                                       seed=slots)
    want = ttl.ticket_lock_plain(torch.from_numpy(arr), torch.from_numpy(m),
                                 torch.from_numpy(b))
    np.testing.assert_array_equal(grant, want[0].numpy())
    np.testing.assert_array_equal(trace, want[1].numpy())
    assert np.float32(acc).view(np.int32) == want[2].numpy().view(np.int32)


def test_model_with_more_slots_than_requesters():
    arr, m, b = _trace(3, 5)
    grant, trace, _ = ttl.ticket_lock_schedule_model(arr, m, b, 1024)
    assert grant == arr.tolist() and trace == list(range(5))


def test_model_rejects_no_slots():
    with pytest.raises(ValueError, match="slots"):
        ttl.ticket_lock_schedule_model([0], [1.0], [0.0], 0)
