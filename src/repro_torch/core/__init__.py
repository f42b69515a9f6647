"""JoinML-X core on PyTorch: the paper's algorithms (WWJ, BAS), its
baselines, the multi-fidelity cascade, selection and the join-order planner,
the persistent stratification index, and the query engine.

Exports what the reference's ``repro.core`` exports."""
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
from .cascade import (  # noqa: F401
    SimilarityProxyOracle,
    run_bas_cascade,
    similarity_proxy,
)
from .dispatch import choose_path, dense_weight_bytes, run_auto  # noqa: F401
from .index import (  # noqa: F401
    IndexArtifact,
    IndexStore,
    append_rows,
    artifact_key,
    build_index,
    table_fingerprint,
)
from .baselines import (  # noqa: F401
    calibrate_threshold,
    run_abae,
    run_blazeit,
    run_blocking,
    run_uniform,
    run_wwj,
)
from .selection import (  # noqa: F401
    run_bas_groupby,
    run_bas_selection,
    run_topk_heavy_hitters,
)
from .engine import Catalog, JoinMLEngine, Table, parse_query  # noqa: F401
from .planner import (  # noqa: F401
    bas_cardinality_provider,
    dp_chain_plan,
    plan_cost_under_truth,
    uniform_cardinality_provider,
)
