"""`collate_ms` of the pretrain stage's cells, from the port's recorder
(``lib/program.py::collate_ms``)."""

from portbench.lib.program import collate_ms as read  # noqa: F401
