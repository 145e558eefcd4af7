"""Importing this package registers every checker with the registry."""
from repro_torch.analysis.checkers import (  # noqa: F401
    donation, host_sync, locks, overflow, retrace,
)
