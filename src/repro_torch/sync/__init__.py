"""Backend-unified synchronization API (counterpart of ``repro.sync``):
protocols + plan types, backends (host / cuda / ref), the
``SyncLibrary`` factory and planner with the cached host
classification (``classified_host``, ``SyncLibrary.for_host``), the
shared windowed planner, and the backend registry (``register_backend``,
``get_backend``, ``available_backends``)."""

from repro_torch.sync.backends import (  # noqa: F401
    HostBackend,
    KernelBackend,
    SyncBackend,
    available_backends,
    get_backend,
    register_backend,
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
