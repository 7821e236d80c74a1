"""prefill_idle_share.serve: percent of the traced waves' prefill
stretches (hand-off to first token) in which no operation ran on the
card."""
from bench.core.readers import idle_share


def read(rec):
    return idle_share(rec, "prefill_intervals")
