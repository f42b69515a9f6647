"""The metrics read from the program's own spans and counters
(``harness/program_log.py``), in a traced CPU rehearsal of each cell: the
served cell ``olmoe-names.served-8`` from its real files (every query's
Oracle attached to one ``OracleService``, its checks held), and each
metric of a span or counter that lists a cell reads a number there."""
import pytest

import run
from harness import spec
from harness.session import Session

PROGRAM = ("program_span", "program_counter")


def _traced(workload: str, seed: int = 12345):
    """(cell, window, per-layer readings, service stats) of one traced
    rehearsal window, a query a client."""
    from repro_torch.obs import telemetry

    cell = spec.load_cell(workload, rehearse=True)
    s = Session(cell, seed, "cpu")
    s.setup()
    try:
        telemetry.clear_window_log()
        win = s.window(n_queries=1, trace=True)
        ctx = run.Context(s, win, 0.0)
        read = {m.name: m.reader.read(ctx) for m in cell.metrics_of("per_layer")
                if m.entry["source"] in PROGRAM}
        checks = s.checks(win)
        stats = s.service.stats() if s.service is not None else None
    finally:
        s.close()
        telemetry.clear_window_log()
    assert all(v <= cell.config["limits"][k] for k, v in checks.items()), checks
    return cell, win, read, stats


def test_served_cell_reads_its_metrics():
    cell, win, read, stats = _traced("olmoe-names.served-8")
    assert cell.mix["service"] == {"workers": 1, "max_wait_ms": 8, "label_store_mb": 64}
    assert cell.mix["clients"] == 3      # the rehearsal's; the cell runs 8
    assert len(win.completed) == 3 and len(win.records) == 3
    assert stats["windows"] >= 1 and stats["segments"] > stats["windows"]
    assert set(read) == {"scorer_token_fill", "moe_slot_fill", "queue_wait_ms", "window_fill"}
    assert all(v is not None for v in read.values()), read
    for share in ("scorer_token_fill", "moe_slot_fill", "window_fill"):
        assert 0 < read[share] <= 100, (share, read[share])
    # capacity 1.25: the kept tokens fill at most 1 / 1.25 of the slots
    assert read["moe_slot_fill"] <= 80 + 1e-9
    assert read["queue_wait_ms"] > 0
    assert read["window_fill"] == pytest.approx(100 * stats["window_fill_ratio"])
    assert all("queue_wait_s" in r.timings and "service_window_s" in r.timings
               for r in win.completed)


@pytest.mark.parametrize("workload", ["olmoe-names.count-b2k", "labels-262k.cold-fp32"])
def test_program_metrics_read_in_a_traced_rehearsal(workload):
    cell, win, read, _ = _traced(workload)
    new = {"olmoe-names.count-b2k": {"tokenize_ms", "scorer_token_fill", "moe_slot_fill"},
           "labels-262k.cold-fp32": {"upload_ms"}}[workload]
    assert new <= set(read)
    assert all(v is not None and v > 0 for v in read.values()), read
    for name in new & {"scorer_token_fill", "moe_slot_fill"}:
        assert read[name] <= 100
    if "upload_ms" in new:
        assert read["upload_ms"] <= read["stratify_ms"]
