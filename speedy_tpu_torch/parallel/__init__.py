"""Batch engine of the port."""
