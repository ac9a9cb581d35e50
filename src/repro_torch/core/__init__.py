"""The paper's machine abstraction and the host-side primitives
(counterpart of ``repro.core``): ``abstraction.py`` (Table 1 rows,
classification, Table 5 selection) and ``hostsync.py`` (threading
mutexes and semaphores); ``device.py`` resolves where entry points run."""

from repro_torch.core.abstraction import (  # noqa: F401
    FERMI,
    TESLA,
    TPU_V5E,
    BenchTimes,
    ImplChoice,
    MachineAbstraction,
    PrimitiveKind,
    WaitStrategy,
    classify,
    select_backend,
    select_impl,
    select_wait_strategy,
)
