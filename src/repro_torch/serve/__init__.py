"""Serving: the batched pair scorer (the Oracle endpoint), continuous
batching over the decode step, and the serving plane — the oracle service
that coalesces concurrent queries' flushes, its shared label store, and the
TCP transport that puts a network in front of it."""
from .label_store import LabelStore, persistable_key  # noqa: F401
from .oracle_service import (  # noqa: F401
    AdmissionRejected,
    OracleService,
    serve_queries,
)
from .serve_loop import ContinuousBatcher, PairScorer, Request  # noqa: F401
from .transport import (  # noqa: F401
    OracleServiceServer,
    RemoteExecutionError,
    RemoteOracle,
    RemoteWorkerClient,
    ServiceConnection,
    TransportError,
    parse_address,
    scorer_group,
)
