"""`wmd_label_host_ms` of the pretrain stage's cells, from the port's recorder
(``lib/program.py::wmd_label_host_ms``)."""

from portbench.lib.program import wmd_label_host_ms as read  # noqa: F401
