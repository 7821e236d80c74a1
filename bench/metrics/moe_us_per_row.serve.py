"""moe_us_per_row.serve: device microseconds of the program's MoE FFN
(``model.moe`` spans) per prefilled row (the ``rows`` of ``serve.prefill``
spans, pad and patch rows included), over the traced waves' prefills.

The span readers' shared helpers live here too: the head and slot-fill
readers load this file."""


def spans_under(rec, root):
    """The program's span records that start inside the traced stretch and
    descend from (or are) a ``root`` span; None where there are none (no
    trace, or a program without spans)."""
    tr = rec.get("trace")
    if not tr:
        return None
    from repro_torch import obs
    if not hasattr(obs, "span_records"):
        return None
    lo, hi = tr["lo"], tr["hi"]
    inside = {r["seq"]: r for r in obs.span_records()
              if lo <= r["start_ns"] * 1e-9 <= hi}

    def under(r):
        while r is not None:
            if r["name"] == root:
                return True
            r = inside.get(r["parent"])
        return False
    out = [r for r in inside.values() if under(r)]
    return out or None


def prefill_spans(rec):
    return spans_under(rec, "serve.prefill")


def per_row(rec, name):
    """1e6 x the device seconds of the prefills' ``name`` spans over the
    prefills' rows; None where either is missing."""
    spans = prefill_spans(rec)
    if spans is None:
        return None
    rows = sum(r["attrs"]["rows"] for r in spans
               if r["name"] == "serve.prefill")
    busy = sum(r["device_s"] for r in spans if r["name"] == name)
    if not rows or not busy:
        return None
    return 1e6 * busy / rows


def moe_sums(spans):
    """The ``kept``, ``routed`` and ``slots`` counters of the ``model.moe``
    spans among ``spans``, summed."""
    moe = [r["attrs"] for r in spans if r["name"] == "model.moe"]
    return {k: sum(a.get(k, 0) for a in moe)
            for k in ("kept", "routed", "slots")}


def read(rec):
    return per_row(rec, "model.moe")
