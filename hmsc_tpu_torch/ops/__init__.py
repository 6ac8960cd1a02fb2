"""Random draws and small linear algebra, with the hand-written kernels
B1-B3 behind their wrappers."""
