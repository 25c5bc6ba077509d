"""`graph_nodes` of the optimize stage's cells, from the port's recorder
(``lib/program.py::graph_nodes``)."""

from portbench.lib.program import graph_nodes as read  # noqa: F401
