"""`data_wait_ms` of the pretrain stage's cells (``lib/readers.py::data_wait_ms``)."""

from portbench.lib.readers import data_wait_ms as read  # noqa: F401
