"""flash_attention_roofline.serve: the least time of the traced waves'
prefill flash_attention calls over the device time of these kernels."""
from bench.core.readers import attention_roofline

KERNELS = ("fa_fwd_tc",)


def read(rec):
    return attention_roofline(rec, KERNELS)
