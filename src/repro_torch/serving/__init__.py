"""Queue and latency bookkeeping shared by the serving paths."""
