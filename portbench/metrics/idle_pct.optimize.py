"""`idle_pct` of the optimize stage's cells (``lib/readers.py::idle_pct``)."""

from portbench.lib.readers import idle_pct as read  # noqa: F401
