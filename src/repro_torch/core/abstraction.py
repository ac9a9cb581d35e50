"""Machine abstraction from Stuart & Owens 2011, Section 4 (a copy of
``repro.core.abstraction`` for the PyTorch port).

The paper abstracts a many-core machine by the three memory-system
characteristics that decide which synchronization algorithm wins:

  P1  atomic:volatile access-time ratio (esp. under contention)
  P2  contentious:noncontentious volatile access ratio
  P3  line-hostage behavior: does an atomic unit with a non-empty queue
      serialize *volatile* accesses to the held line?

``MachineAbstraction`` carries the raw per-access costs (so the simulator in
``memsim.py`` can replay the paper's benchmarks) plus the derived ratios, and
``select_impl`` reproduces the paper's Table 5 strategy choices from the
ratios alone.

Built-in machines:

  * TESLA  — GTX295 (GT200), parameterized from paper Table 1.
  * FERMI  — GTX580 (GF100), parameterized from paper Table 1.
  * TPU_V5E — the JAX package's accelerator: no global atomics at all
             (the atomic:volatile ratio is ``inf``), kept as the reference
             has it.

There is no H100 row yet: it has to come from measurements on the card
(the memory-benchmark kernel), not from assumptions.

Paper Table 1 raw numbers (ms per 1000 accesses per block, saturated GPU;
240 blocks Tesla, 128 blocks Fermi):

                                    Tesla R   Tesla W   Fermi R   Fermi W
  Contentious volatile               0.848     0.829     0.494     0.175
  Noncontentious volatile            0.590     0.226     0.043     0.029
  Contentious atomic                78.407    78.404     1.479     1.470
  Noncontentious atomic              0.845     0.991     0.437     0.312
  Contentious volatile after atomic  0.923     0.915     1.473     0.824
  Noncont. volatile after atomic     0.601     0.228     0.125     0.050
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class WaitStrategy(enum.Enum):
    """How a participant waits (paper Section 5 definitions)."""

    SPIN = "spin"              # aggressively retry the serializing (atomic) op
    SPIN_BACKOFF = "backoff"   # spin with exponential-ish backoff sleeps
    SLEEP = "sleep"            # all serializing ops up front, then poll volatile


class PrimitiveKind(enum.Enum):
    BARRIER = "barrier"
    MUTEX = "mutex"
    SEMAPHORE = "semaphore"


@dataclasses.dataclass(frozen=True)
class BenchTimes:
    """One Table-1 style measurement set (ms per 1000 accesses per block)."""

    contentious_volatile: float
    noncontentious_volatile: float
    contentious_atomic: float
    noncontentious_atomic: float
    contentious_volatile_after_atomic: float
    noncontentious_volatile_after_atomic: float


@dataclasses.dataclass(frozen=True)
class MachineAbstraction:
    """The paper's 3-parameter machine abstraction (+ raw costs for the sim)."""

    name: str
    reads: BenchTimes
    writes: BenchTimes
    saturated_blocks: int  # blocks at full saturation in the Table-1 runs

    # ------------------------------------------------------------------ P1
    @property
    def atomic_volatile_ratio(self) -> float:
        """P1 under contention (reads; paper Table 3 row 1)."""
        if math.isinf(self.reads.contentious_atomic):
            return math.inf
        return self.reads.contentious_atomic / self.reads.contentious_volatile

    # ------------------------------------------------------------------ P2
    @property
    def contention_ratio(self) -> float:
        """P2 for volatile reads (paper Table 2 row 1)."""
        return self.reads.contentious_volatile / self.reads.noncontentious_volatile

    # ------------------------------------------------------------------ P3
    @property
    def line_hostage(self) -> bool:
        """P3: atomic unit serializes volatile accesses on a held line.

        Detected exactly as in the paper: volatile accesses preceded by an
        atomic slow down to near-atomic times (we use a 2x threshold over the
        plain volatile time).
        """
        if math.isinf(self.reads.contentious_atomic):
            return False
        return (
            self.reads.contentious_volatile_after_atomic
            > 2.0 * self.reads.contentious_volatile
        )

    @property
    def has_atomics(self) -> bool:
        return not math.isinf(self.reads.contentious_atomic)

    # ----------------------------------------------------------- per-access
    # Per-access service times in microseconds, used by memsim. Table 1 times
    # are ms for (1000 accesses x saturated_blocks) issued concurrently; the
    # *serialized* resources (atomic unit / contended line) service the whole
    # stream, so per-access service time = total_time / (1000 * blocks).
    # Noncontentious accesses proceed in parallel across blocks, so their
    # per-access latency = total_time / 1000.
    def atomic_service_us(self, write: bool = False) -> float:
        t = self.writes if write else self.reads
        if math.isinf(t.contentious_atomic):
            return math.inf
        return t.contentious_atomic * 1e3 / (1000.0 * self.saturated_blocks)

    def volatile_contended_service_us(self, write: bool = False) -> float:
        t = self.writes if write else self.reads
        return t.contentious_volatile * 1e3 / (1000.0 * self.saturated_blocks)

    def volatile_latency_us(self, write: bool = False) -> float:
        t = self.writes if write else self.reads
        return t.noncontentious_volatile * 1e3 / 1000.0

    def atomic_latency_us(self, write: bool = False) -> float:
        t = self.writes if write else self.reads
        if math.isinf(t.noncontentious_atomic):
            return math.inf
        return t.noncontentious_atomic * 1e3 / 1000.0

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        return {
            "name": self.name,
            "P1_atomic_volatile_ratio": self.atomic_volatile_ratio,
            "P2_contention_ratio": self.contention_ratio,
            "P3_line_hostage": self.line_hostage,
            "has_atomics": self.has_atomics,
        }


# --------------------------------------------------------------------------
# Built-in machines (paper Table 1).
# --------------------------------------------------------------------------

TESLA = MachineAbstraction(
    name="tesla-gtx295",
    reads=BenchTimes(0.848, 0.590, 78.407, 0.845, 0.923, 0.601),
    writes=BenchTimes(0.829, 0.226, 78.404, 0.991, 0.915, 0.228),
    saturated_blocks=240,
)

FERMI = MachineAbstraction(
    name="fermi-gtx580",
    reads=BenchTimes(0.494, 0.043, 1.479, 0.437, 1.473, 0.125),
    writes=BenchTimes(0.175, 0.029, 1.470, 0.312, 0.824, 0.050),
    saturated_blocks=128,
)

# The target accelerator. TPUs expose NO global-memory atomics; the
# "atomic" column is infinite and every primitive must be built from
# single-owner flags + hardware semaphores (see DESIGN.md §2). Volatile
# numbers are nominal HBM round-trip placeholders (same units as above)
# used only for strategy selection, not simulation.
TPU_V5E = MachineAbstraction(
    name="tpu-v5e",
    reads=BenchTimes(1.0, 0.6, math.inf, math.inf, 1.0, 0.6),
    writes=BenchTimes(1.0, 0.6, math.inf, math.inf, 1.0, 0.6),
    saturated_blocks=2,  # megacore: 2 concurrent cores per chip
)


def classify(machine: MachineAbstraction) -> str:
    """Bucket a machine the way the paper's Section 4 narrative does."""
    if not machine.has_atomics:
        return "no-atomics"  # TPU-like: only flag/semaphore algorithms exist
    if machine.atomic_volatile_ratio >= 10.0:
        return "tesla-class"  # contentious atomics catastrophic -> sleep
    if machine.line_hostage:
        return "fermi-class"  # fast atomics but line hostage -> spin+backoff mutex
    return "balanced"


# --------------------------------------------------------------------------
# Paper Table 5 — best implementation per machine, derived from the ratios.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImplChoice:
    primitive: PrimitiveKind
    algorithm: str       # e.g. "xf", "fa", "spin", "spin_backoff", "sleeping"
    strategy: WaitStrategy
    rationale: str
    backend: str = "host"  # execution substrate: host | cuda | ref


def select_backend(machine: MachineAbstraction) -> str:
    """Pick the execution backend for a machine abstraction.

    Measured hosts run the threading implementations (``"host"``; their
    hot-loop plans go to the engine device's planner, see
    ``SyncLibrary.planning_backend_name``); GPU abstractions plan through
    the hand-written CUDA kernels (``"cuda"``); a machine without
    atomics (the TPU row) has no substrate in this port and plans
    through the plain versions (``"ref"``).
    """
    if machine.name.startswith("host"):
        return "host"
    if not machine.has_atomics:
        return "ref"
    return "cuda"


def select_impl(
    machine: MachineAbstraction,
    primitive: PrimitiveKind,
    *,
    semaphore_initial: int = 1,
    expected_contention: float = 1.0,
    backend: Optional[str] = None,
) -> ImplChoice:
    """Reproduce paper Table 5 from the abstraction parameters, extended
    to a full (backend, algorithm, wait-strategy) selection triple.

    ``expected_contention`` in [0,1]: fraction of participants expected to
    contend simultaneously; low contention relaxes toward cheaper spin ops
    (paper Section 6, last paragraph). ``backend`` pins the execution
    substrate; ``None`` derives it from the machine via
    ``select_backend``.
    """
    choice = _select_algorithm(machine, primitive, semaphore_initial,
                               expected_contention)
    return dataclasses.replace(
        choice, backend=backend if backend is not None
        else select_backend(machine))


def select_wait_strategy(
    machine: MachineAbstraction,
    measured_contention: float,
) -> WaitStrategy:
    """Re-select a mutex wait strategy from *measured* contention.

    This is the paper's Section-6 spin-vs-sleep guideline turned into a
    runtime decision: ``measured_contention`` is the observed fraction of
    contended acquires over a recent window (e.g.
    ``hostsync.TicketMutex.recent_contention``), not an a-priori
    estimate. Contention-adaptive callers (``AdaptiveMutex``) re-resolve
    between scheduler rounds — never mid-critical-section — so a lock
    that measures uncontended relaxes to cheap spinning and a lock that
    saturates falls back to the bounded-atomics sleep discipline.

      * uncontended: aggressive spinning has the fewest total accesses —
        the retried atomic almost always succeeds first try;
      * moderate: backoff lets the atomic unit's queue drain (paper:
        +40-60% on Fermi-class machines, whose line hostage punishes
        tight polling at any contention level);
      * saturated: front-load the atomics and poll a volatile word
        (sleep) — on Tesla-class machines (contentious atomics 10-90x
        volatile) the threshold for giving up on spinning is far lower.
    """
    c = min(max(float(measured_contention), 0.0), 1.0)
    if not machine.has_atomics:
        return WaitStrategy.SLEEP          # only flag/poll algorithms exist
    cls = classify(machine)
    if cls == "tesla-class":
        return (WaitStrategy.SPIN if c < 0.02 else WaitStrategy.SLEEP)
    if c < 0.10:
        return WaitStrategy.SPIN
    if cls == "fermi-class" or c < 0.50:
        return WaitStrategy.SPIN_BACKOFF
    return WaitStrategy.SLEEP


def _select_algorithm(
    machine: MachineAbstraction,
    primitive: PrimitiveKind,
    semaphore_initial: int,
    expected_contention: float,
) -> ImplChoice:
    cls = classify(machine)

    if primitive is PrimitiveKind.BARRIER:
        # XF wins on every machine the paper measured; on a no-atomics
        # machine it is also the only possibility (single-owner flags).
        return ImplChoice(
            primitive, "xf", WaitStrategy.SLEEP,
            "decentralized single-owner flags; no atomics; minimal contention",
        )

    if primitive is PrimitiveKind.MUTEX:
        if cls in ("no-atomics", "tesla-class"):
            return ImplChoice(
                primitive, "fa", WaitStrategy.SLEEP,
                "contentious atomics prohibitive (or absent): one FA up "
                "front, volatile-poll the turn counter",
            )
        if cls == "fermi-class" and expected_contention >= 0.25:
            return ImplChoice(
                primitive, "spin_backoff", WaitStrategy.SPIN_BACKOFF,
                "fast atomics + line hostage punishes FA polling; "
                "backoff lets the atomic queue drain (paper: +40-60%)",
            )
        if cls == "fermi-class":
            return ImplChoice(
                primitive, "spin", WaitStrategy.SPIN,
                "low contention: raw spin lock has the fewest total accesses",
            )
        return ImplChoice(
            primitive, "fa", WaitStrategy.SLEEP,
            "balanced machine: fairness for free, bounded atomics",
        )

    # Semaphore.
    if cls == "fermi-class" and semaphore_initial <= 1:
        return ImplChoice(
            primitive, "spin_backoff", WaitStrategy.SPIN_BACKOFF,
            "paper Table 5: initial value 1 at scale on Fermi — spin "
            "w/ backoff overtakes sleeping",
        )
    return ImplChoice(
        primitive, "sleeping", WaitStrategy.SLEEP,
        "<=1 atomic under capacity, <=2 atomics in post, fair, scales "
        "with initial value (paper: up to 60-70x over spin)",
    )
