"""`mfu` of the pretrain stage's cells (``lib/readers.py::mfu``)."""

from portbench.lib.readers import mfu as read  # noqa: F401
