"""The paper's machine abstraction and the host-side primitives
(counterpart of ``repro.core``): ``abstraction.py`` (Table 1 rows,
classification, Table 5 selection), ``memsim.py`` and
``primitives_sim.py`` (the discrete-event reproduction of the paper's
benchmarks and Algorithms 1-5), ``hostbench_probe.py`` (this host's
abstraction, measured) and ``hostsync.py`` (threading mutexes,
semaphores and barriers); ``device.py`` resolves where entry points run."""

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
from repro_torch.core.memsim import MemSim, run_membench  # noqa: F401
from repro_torch.core.primitives_sim import (  # noqa: F401
    BackoffConfig,
    CriticalSectionMonitor,
    PrimitiveResult,
    run_primitive,
)
