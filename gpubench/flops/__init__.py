"""Operation and byte counts of the models, from shapes alone."""

#: Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W).
PEAK_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_F32 = 67e12          # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12      # B/s, HBM3
