"""Decompression with the port's device stages (``parallel.decode``)."""
