"""`device_ms_per_step` of the pretrain stage's cells (``lib/readers.py::device_ms_per_step``)."""

from portbench.lib.readers import device_ms_per_step as read  # noqa: F401
