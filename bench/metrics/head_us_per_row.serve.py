"""head_us_per_row.serve: device microseconds of the program's head
(``model.head`` spans: final norm and unembedding) per prefilled row (the
``rows`` of ``serve.prefill`` spans, pad and patch rows included), over
the traced waves' prefills.  A span's device time is the stream time
between its two timing events, so it holds any device idle inside the
span: where the head's kernels take about as long as their launches,
this reads launch time."""
from pathlib import Path

from bench.core.harness import module_at

SPANS = module_at(Path(__file__).with_name("moe_us_per_row.serve.py"),
                  "bench_metric_moe_us_per_row_serve")


def read(rec):
    return SPANS.per_row(rec, "model.head")
