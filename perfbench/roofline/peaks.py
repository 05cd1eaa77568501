"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
that limit runs slower; runs print the card's limit beside their numbers."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12   # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
HBM_BYTES = 80e9
