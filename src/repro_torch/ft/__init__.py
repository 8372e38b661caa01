"""Fault tolerance of the training path: the checkpoint / crash / restart
supervisor and the straggler monitor (the reference's ``repro/ft``)."""
from .supervisor import Supervisor, FailureInjector, TrainResult
from .straggler import StragglerMonitor

__all__ = ["Supervisor", "FailureInjector", "TrainResult", "StragglerMonitor"]
