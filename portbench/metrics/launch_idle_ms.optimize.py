"""`launch_idle_ms` of the optimize stage's cells, from the port's recorder
(``lib/program.py::launch_idle_ms``)."""

from portbench.lib.program import launch_idle_ms as read  # noqa: F401
