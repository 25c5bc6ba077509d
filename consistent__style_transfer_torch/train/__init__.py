"""Stage entry points of the port. This slice carries test-mode inference."""
