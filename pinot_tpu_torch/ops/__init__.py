"""Device operators of the port: torch ops and the hand-written CUDA scan."""
