"""device_idle_share.train: percent of the traced training steps in which
no operation ran on the card (torch.profiler, CUPTI)."""
from bench.core.readers import idle_share


def read(rec):
    return idle_share(rec)
