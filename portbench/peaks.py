"""Published peaks of the card the benchmark runs on: NVIDIA H100 SXM
(80 GB HBM3), NVIDIA's data sheet, at its 700 W limit.  The rooflines
are bytes-bound: the walkers do a few operations a byte."""

H100_SXM = dict(hbm_bytes_per_s=3.35e12)
