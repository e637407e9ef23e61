"""Hand-written Hopper kernels: <name>.py (wrapper + plain version) + csrc/."""
