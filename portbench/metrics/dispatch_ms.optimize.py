"""`dispatch_ms` of the optimize stage's cells (``lib/readers.py::dispatch_ms``)."""

from portbench.lib.readers import dispatch_ms as read  # noqa: F401
