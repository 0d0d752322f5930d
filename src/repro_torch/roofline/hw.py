"""NVIDIA H100 constants: the dry-run's roofline denominators.

Port of ``repro.roofline.hw``, whose figures are a TPU v5e's; none of them
carries over. Every figure here is NVIDIA's data-sheet value for the H100
SXM5 80GB HBM3 at its 700 W power limit (``nvidia-smi`` names the card
"NVIDIA H100 80GB HBM3"; a card set below 700 W runs slower under load).
They are peaks, not measurements: ``chip_smoke.py``'s ``dryrun`` phase
measures the copy rate and the bf16 matmul rate as shares of them.

The collective term of ``analysis.roofline_terms`` divides a rank's
collective bytes by one link rate, ``LINK_BW``, as the reference's does by
its ICI rate. That is NVLink inside one node of ``NODE_CARDS`` cards. An
axis that spans more than one node (every axis of the 16 x 16 and
2 x 16 x 16 production meshes past 8 ranks) moves over InfiniBand at about
``IB_BW`` a card, so for such an axis the term is a lower bound.
"""

# H100 80GB HBM3 (SXM5), 700 W: dense bf16 tensor-core peak, FLOP/s
PEAK_FLOPS_BF16 = 989e12
# H100 80GB HBM3 (SXM5), 700 W: f32 FMA peak (no tensor cores), FLOP/s
PEAK_FLOPS_F32 = 67e12
# H100 80GB HBM3 (SXM5), 700 W: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# H100 80GB HBM3 (SXM5), 700 W: device memory, bytes
HBM_BYTES = 80e9
# H100 80GB HBM3 (SXM5), 700 W: NVLink 4, 900 GB/s bidirectional a card, so
# 450 GB/s in each direction, bytes/s
LINK_BW = 450e9
# H100 80GB HBM3 (SXM5), 700 W: cards a node joins by NVLink (an HGX board)
NODE_CARDS = 8
# H100 80GB HBM3 (SXM5), 700 W: one 400 Gb/s InfiniBand NIC a card, about
# 50 GB/s in each direction, bytes/s (an axis wider than a node)
IB_BW = 50e9

# the production meshes' logical sizes (launch/mesh.py::make_production_mesh)
CHIPS_PER_POD = 256
PODS = 2
