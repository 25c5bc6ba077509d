"""`dispatch_ms` of the pretrain stage's cells (``lib/readers.py::dispatch_ms``)."""

from portbench.lib.readers import dispatch_ms as read  # noqa: F401
