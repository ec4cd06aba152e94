"""Hand-written Hopper kernels, their wrappers and their plain versions."""
