"""`prefetch_ready_pct` of the pretrain stage's cells, from the port's recorder
(``lib/program.py::prefetch_ready_pct``)."""

from portbench.lib.program import prefetch_ready_pct as read  # noqa: F401
