"""`capture_s` of the optimize stage's cells, from the port's recorder
(``lib/program.py::capture_s``)."""

from portbench.lib.program import capture_s as read  # noqa: F401
