"""Continuous-batching serving over a contiguous slot arena or a paged KV
arena (counterpart of ``repro.serve``): kv_slots, kv_pages, scheduler,
dispatch, engine, the request lifecycle's faults and async frontend, and
the seeded lifecycle traces of fuzz."""

from repro_torch.serve.engine import (  # noqa: F401
    GenerationResult,
    RequestState,
    ServeEngine,
    ServeRequest,
    SlotServeEngine,
)
from repro_torch.serve.faults import (  # noqa: F401
    FaultPlan,
    InjectedFault,
)
from repro_torch.serve.frontend import (  # noqa: F401
    AsyncFrontend,
    IntakeFullError,
    RequestFailedError,
    StreamHandle,
)
from repro_torch.serve.kv_pages import (  # noqa: F401
    PagedSlotPool,
    PagePool,
    PagePoolExhausted,
)
from repro_torch.serve.kv_slots import SlotPool  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    AdmissionController,
    ContinuousBatcher,
    Request,
    allocator_contention,
    plan_admission,
)
