"""Backend-unified synchronization API (counterpart of ``repro.sync``):
protocols + plan types, backends (host / cuda / ref), the
``SyncLibrary`` factory and planner, and the shared windowed planner."""

from repro_torch.sync.backends import (  # noqa: F401
    HostBackend,
    KernelBackend,
    SyncBackend,
)
from repro_torch.sync.library import HOST_NOMINAL, SyncLibrary  # noqa: F401
from repro_torch.sync.protocols import (  # noqa: F401
    Mutex,
    Semaphore,
    SemaphorePlan,
)
from repro_torch.sync.window import WindowedPlanner  # noqa: F401
