"""flash_attention_roofline.train: the least time of the traced steps'
flash_attention calls over the device time of these kernels."""
from bench.core.readers import attention_roofline

KERNELS = ("fa_fwd_tc",)


def read(rec):
    return attention_roofline(rec, KERNELS)
