"""Random draws, small linear algebra and masked grams, with the
hand-written kernels B1-B3, B5 and B6 behind their wrappers."""
