"""Fault tolerance shared by the serving paths."""
from repro_torch.runtime.fault import FailureInjector, StepWatchdog

__all__ = ["FailureInjector", "StepWatchdog"]
