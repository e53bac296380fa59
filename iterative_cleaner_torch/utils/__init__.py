"""Host-side helpers of the port's CLI session: ``clean.log``, the zap
plot, the checkpoints (``--checkpoint``) and the trace (``--trace``)."""
