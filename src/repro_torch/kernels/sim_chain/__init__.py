"""The chain simulator's round loop as one hand-written kernel (``sim_chain``)."""
