"""The MPC join on the torch data plane: the round-program IR (``program``),
the dataplane executor (``executors``) and the join service (``service``),
with the grid geometry (``cartesian``, ``hypercube``) and typed errors
(``faults``) they share."""

from .executors import BatchRunStats, DataplaneExecutor, DataplaneJoinResult, DataplaneUnsupported
from .faults import (
    DeadlineExceededError,
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
)
from .service import JoinSession, ServiceStats, SessionResult
