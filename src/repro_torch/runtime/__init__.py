"""Fault tolerance shared by the serving paths and the training driver."""
from repro_torch.runtime.fault import (DriverConfig, DriverReport,
                                       FailureInjector, StepWatchdog,
                                       TrainingDriver)

__all__ = ["DriverConfig", "DriverReport", "FailureInjector", "StepWatchdog",
           "TrainingDriver"]
