"""Host-side fault tolerance of the trainer: retries, preemption,
stragglers and deterministic data-order resume."""
