"""Backend-unified synchronization API (counterpart of ``repro.sync``):
protocols + plan types, backends (host / cuda / ref), the
``SyncLibrary`` factory and planner with the cached host
classification (``classified_host``, ``SyncLibrary.for_host``), and
the shared windowed planner."""

from repro_torch.sync.backends import (  # noqa: F401
    HostBackend,
    KernelBackend,
    SyncBackend,
)
from repro_torch.sync.library import (  # noqa: F401
    HOST_NOMINAL,
    SyncLibrary,
    SyncTimeoutError,
    classified_host,
)
from repro_torch.sync.protocols import (  # noqa: F401
    Barrier,
    BarrierPlan,
    BoundedMutexPlan,
    Mutex,
    MutexPlan,
    Semaphore,
    SemaphorePlan,
)
from repro_torch.sync.window import WindowedPlanner  # noqa: F401
