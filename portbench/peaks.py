"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
700 W power limit).  A share of a peak is stated with the card's power
limit beside it."""

HBM_BYTES_PER_S = 3.35e12
