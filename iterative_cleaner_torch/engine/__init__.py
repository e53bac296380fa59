"""The iteration engine of the port."""
