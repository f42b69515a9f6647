"""JoinML-X core on PyTorch: the streaming and dense BAS query engine.

Exports only what is ported; the cascade, index, baselines, selection and
planner modules of the reference follow in later parts of the port."""
from ..obs import QueryTelemetry  # noqa: F401 — QueryResult.telemetry type
from .types import (  # noqa: F401
    Agg,
    BASConfig,
    ConfidenceInterval,
    JoinSpec,
    Query,
    QueryResult,
    constant_attr,
)
from .oracle import (  # noqa: F401
    ArrayOracle,
    FnOracle,
    LabelRequest,
    LabelResult,
    ModelOracle,
    Oracle,
    OracleBatch,
    OracleRequest,
    PairChainOracle,
)
from .bas import run_bas, run_exact, run_stratified_pipeline  # noqa: F401
from .bas_streaming import run_bas_streaming  # noqa: F401
from .dispatch import choose_path, dense_weight_bytes, run_auto  # noqa: F401
from .engine import Catalog, JoinMLEngine, Table, parse_query  # noqa: F401
