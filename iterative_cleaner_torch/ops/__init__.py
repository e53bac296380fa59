"""DSP primitives of the port (dispersion, rotation, baselines)."""
