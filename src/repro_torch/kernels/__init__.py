"""Hand-written Hopper kernels and their wrappers.  Importing this package
builds nothing: the CUDA source compiles at the first launch on a card."""
