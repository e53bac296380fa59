"""Host-side helpers of the port's CLI session."""
