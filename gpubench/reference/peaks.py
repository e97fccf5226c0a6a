"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data
sheet, at the full power limit of 700 W.  A card set below it runs slower
under load: the harness prints the limit beside every result."""

HBM_BYTES_PER_S = 3.35e12
