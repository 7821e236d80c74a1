"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Every share of a peak or
of a roofline that the benchmark reports is taken against these."""

BF16_FLOPS = 989e12        # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES = 3.35e12        # bytes/s, HBM3
