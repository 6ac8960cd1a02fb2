"""Random draws, small linear algebra, masked grams and the NNGP
operators, with the hand-written kernels B1-B3, B5, B6 and B8a-B8c behind
their wrappers."""
