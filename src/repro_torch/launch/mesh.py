"""The card the port runs on, in place of the reference's TPU meshes.

On one H100 the step API places everything on one device, so there is
no mesh to build.  The roofline terms use the card's published peaks,
spec-sheet figures from NVIDIA's H100 SXM data sheet (dense, without
sparsity, at the full 700 W power limit), never measurements; one card
has no interconnect term.
"""

# H100 SXM spec-sheet figures (roofline denominators, not measured)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12               # B/s
HBM_BYTES = 80e9               # B of HBM3
