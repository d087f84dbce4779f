"""Sequence-parallel layouts of the port (USP comes in a later slice)."""
