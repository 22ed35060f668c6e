"""The MPC join on the torch data plane and the exact-cost simulator: the
round-program IR (``program``), its static verifier (``verify``), the two
execution backends (``executors``: the dataplane on the card, the metered
``simulator`` on the host with ``statistics``' three metered histogram
rounds), the join service (``service``: synchronous, coalesced and
asynchronous submission) and the one-shot simulator entry point
``engine.mpc_join``, with the grid geometry and routing (``cartesian``,
``hypercube``) and the typed errors and fault injection (``faults``) they
share."""

from .simulator import HashFamily, MPCSimulator
from .faults import (
    DeadlineExceededError,
    DegradedSessionError,
    FaultPlan,
    FaultRule,
    InjectedCompileError,
    InjectedDispatchError,
    InjectedDrainerError,
    InjectedFault,
    JoinServiceError,
    ProgramVerificationError,
    QueryFailedError,
    RetryExhaustedError,
)
from .program import (
    BroadcastSizes,
    GridRoute,
    HashPartition,
    LocalJoin,
    RoundOp,
    RoundProgram,
    RouteResidual,
    RunConfig,
    Scatter,
    SemiJoin,
    coalesce_signature,
    compile_plan,
    fuse_semijoin_pass,
    histogram_signature,
    plan_cache_key,
    programs_coalescible,
)
from .executors import (
    BatchRunStats,
    DataplaneExecutor,
    DataplaneJoinResult,
    DataplaneUnsupported,
    MPCJoinResult,
    SimulatorExecutor,
)
from .service import AdmissionError, JoinSession, ServiceStats, SessionResult
from .engine import mpc_join
