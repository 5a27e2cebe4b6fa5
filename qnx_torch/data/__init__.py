"""Datasets (the port's copy of :mod:`qnx.data`)."""
