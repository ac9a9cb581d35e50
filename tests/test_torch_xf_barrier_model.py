"""The CUDA barrier kernel's schedule, modelled on the CPU
(``xf_barrier_schedule_model``: thread slots that each own every T-th
participant, a master that first waits for every present flag and then
polls the required ones within the budget, stepped in seeded
interleavings), held to the JAX package's Pallas kernel (interpret mode)
and its oracle.

The model asserts on every poll of the unbudgeted wait that the master
waits only on flags some slot will still write. Every output is exact,
whatever the poll budget: on the TPU's sequential grid the result never
depended on it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xf_barrier.kernel import xf_barrier_pallas
from repro.kernels.xf_barrier.ref import xf_barrier_ref
from repro_torch.kernels import xf_barrier as txb

SLOTS = (1, 7, 32, 1024)


def _case(name, n, seed):
    """(arrive, epoch, present, required) for one named case."""
    rng = np.random.default_rng(seed)
    ones = np.ones(n, np.int32)
    if name == "all":
        return np.zeros(n, np.int32), 1, ones, ones
    if name == "stragglers":
        present = ones.copy()
        present[rng.integers(n)] = 0
        return np.zeros(n, np.int32), 2, present, ones
    return (rng.integers(0, 5, n).astype(np.int32), int(rng.integers(1, 5)),
            (rng.uniform(size=n) < 0.8).astype(np.int32),
            (rng.uniform(size=n) < 0.7).astype(np.int32))


@pytest.mark.parametrize("case", ["all", "stragglers", "random"])
@pytest.mark.parametrize("max_polls", [0, 1, 1024])
@pytest.mark.parametrize("n", [1, 9, 33, 64, 100])
def test_model_matches_pallas_and_oracle(n, max_polls, case):
    arrive, epoch, present, required = _case(case, n, n * 10 + max_polls)
    j = [jnp.asarray(x) for x in (arrive, present, required)]
    wants = ([np.asarray(w) for w in xf_barrier_pallas(
                 j[0], jnp.int32(epoch), j[1], j[2], max_polls=max_polls,
                 interpret=True)],
             [np.asarray(w) for w in xf_barrier_ref(
                 j[0], jnp.int32(epoch), j[1], j[2], max_polls=max_polls)])
    for slots in SLOTS:
        got = txb.xf_barrier_schedule_model(
            arrive, epoch, present, required, slots=slots,
            max_polls=max_polls, seed=slots)
        for want in wants:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,slots", [(300, 32), (1000, 1024), (257, 5),
                                     (2048, 1024)])
@pytest.mark.parametrize("max_polls", [0, 1])
def test_model_equal_to_plain_when_slots_own_several(n, slots, max_polls):
    """More participants than slots (the kernel's N > 1024): each slot
    stores several flags while the master polls, and a budget of 0 or 1
    still gives the plain version's result."""
    for case in ("all", "stragglers", "random"):
        arrive, epoch, present, required = _case(case, n, n + slots)
        got = txb.xf_barrier_schedule_model(
            arrive, epoch, present, required, slots=slots,
            max_polls=max_polls, seed=n)
        want = txb.xf_barrier_plain(torch.from_numpy(arrive), epoch,
                                    torch.from_numpy(present),
                                    torch.from_numpy(required))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


def test_model_of_an_empty_barrier_completes():
    z = np.zeros(0, np.int32)
    arrive, release, done, stragglers = txb.xf_barrier_schedule_model(
        z, 1, z, z, slots=32)
    assert int(done) == 1 and arrive.shape == (0,) and not stragglers.any()


def test_model_rejects_no_slots():
    with pytest.raises(ValueError, match="slots"):
        txb.xf_barrier_schedule_model([0], 1, [1], [1], slots=0)
