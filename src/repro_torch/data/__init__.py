from .synthetic import (  # noqa: F401
    ChainDataset,
    PairDataset,
    dataset_registry,
    make_chain_dataset,
    make_clustered_tables,
    make_syn_scores,
)
