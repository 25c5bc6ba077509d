"""`replay_ms` of the optimize stage's cells, from the port's recorder
(``lib/program.py::replay_ms``)."""

from portbench.lib.program import replay_ms as read  # noqa: F401
