"""Stage entry points of the port: pretrain, and test-mode inference."""
