"""The port's sync backend registry, mirroring the reference's registry
tests (tests/test_sync_api.py): the built-in backends are registered, a
backend registered by a user takes plans through ``SyncLibrary``, its
live constructors fall back to the host substrate, and an unknown name
raises ``KeyError``. A library keeps its own ``host`` / ``cuda`` /
``ref`` objects (their planning windows) and resolves any other name
through the registry."""

import numpy as np
import pytest

from repro_torch.core.abstraction import PrimitiveKind
from repro_torch.core.hostsync import SleepingSemaphore
from repro_torch.sync import (SyncBackend, SyncLibrary, available_backends,
                              get_backend, register_backend)
from repro_torch.sync import backends as sync_backends


@pytest.fixture
def lib():
    return SyncLibrary.host_default()


def test_builtin_backends_registered():
    assert set(available_backends()) >= {"host", "cuda", "ref"}
    assert get_backend("cuda").fast_plans and get_backend("ref").fast_plans
    assert not get_backend("host").fast_plans
    assert get_backend("ref").name == "ref"
    with pytest.raises(KeyError, match="no-such-backend"):
        get_backend("no-such-backend")


def test_register_custom_backend(lib):
    class Recording(SyncBackend):
        fast_plans = True
        calls = 0

        def plan_semaphore(self, arrivals, holds, capacity, *, window=None):
            Recording.calls += 1
            n = len(arrivals)
            z = np.zeros(n, np.float32)
            return z, z, np.zeros(n, np.int32), None

    register_backend("custom-test", Recording())
    try:
        assert "custom-test" in available_backends()
        plan = lib.plan_semaphore([0.0, 1.0], [1.0, 1.0], 1,
                                  backend="custom-test")
        assert plan.backend == "custom-test" and Recording.calls == 1
        # a library pinned to it plans there by default
        pinned = SyncLibrary.host_default(backend="custom-test")
        assert pinned.plan_semaphore([0.0], [1.0], 1).backend == "custom-test"
        assert pinned.planning_backend_name() == "custom-test"
        # live constructors fall back to the host substrate
        sem = get_backend("custom-test").semaphore(
            2, "sleeping", lib.choice(PrimitiveKind.SEMAPHORE).strategy)
        assert isinstance(sem, SleepingSemaphore)
    finally:
        sync_backends._REGISTRY.pop("custom-test", None)
    with pytest.raises(KeyError, match="custom-test"):
        lib.plan_semaphore([0.0], [1.0], 1, backend="custom-test")


def test_library_keeps_its_own_builtin_backends(lib):
    """Each library owns the backends it plans on (their windows), not
    the registry's instances: two libraries never share a window."""
    other = SyncLibrary.host_default()
    assert lib._backend("ref") is not other._backend("ref")
    assert lib._backend("ref") is not get_backend("ref")
    assert lib._backend("host").name == "host"
