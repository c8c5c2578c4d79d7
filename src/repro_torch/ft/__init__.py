"""Fault tolerance: the straggler monitor and failure injection."""
from repro_torch.ft.straggler import FailureInjector, SimulatedFailure, StragglerMonitor  # noqa: F401
