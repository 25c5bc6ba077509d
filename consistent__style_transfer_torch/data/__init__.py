"""Data layer: corpus loading, padding, static-shape batches, device prefetch."""
