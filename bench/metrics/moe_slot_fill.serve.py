"""moe_slot_fill.serve: percent of the MoE's computed expert slots that
hold a routed (token, choice) pair, over the traced waves' prefills: the
``kept`` counters of the program's ``model.moe`` spans over their
``slots`` (G E C: every group's capacity at every expert)."""
from pathlib import Path

from bench.core.harness import module_at

SPANS = module_at(Path(__file__).with_name("moe_us_per_row.serve.py"),
                  "bench_metric_moe_us_per_row_serve")


def read(rec):
    spans = SPANS.prefill_spans(rec)
    if spans is None:
        return None
    sums = SPANS.moe_sums(spans)
    if not sums["slots"]:
        return None
    return 100.0 * sums["kept"] / sums["slots"]
