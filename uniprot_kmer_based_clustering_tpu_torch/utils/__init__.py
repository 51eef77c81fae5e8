"""BLOSUM62 weights, stage timers and checkpoints."""
