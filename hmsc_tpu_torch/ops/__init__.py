"""Random draws, small linear algebra, masked grams, the NNGP operators
and the mixed-precision products, with the hand-written kernels B1-B3,
B5, B6, B8a-B8c and B10 behind their wrappers."""
