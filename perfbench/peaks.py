"""The table of peaks: published figures of one NVIDIA H100 SXM (80 GB
HBM3), NVIDIA's data sheet, dense rates, at the full 700 W power limit.
A card set below it runs slower; the harness prints the card's
``power.limit`` beside every run."""

#: HBM bandwidth, bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations a second.
FP32_FLOPS = 67e12
