"""The MPC join on the torch data plane: the round-program IR (``program``),
the dataplane executor (``executors``) and the join service (``service``:
synchronous, coalesced and asynchronous submission), with the grid geometry
(``cartesian``, ``hypercube``) and the typed errors and fault injection
(``faults``) they share."""

from .executors import BatchRunStats, DataplaneExecutor, DataplaneJoinResult, DataplaneUnsupported
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
from .service import AdmissionError, JoinSession, ServiceStats, SessionResult
