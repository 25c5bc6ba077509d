"""Tensor ops of the port: optimal transport (``emd``) and losses."""
