"""Frozen copy of the port's ``utils`` modules that the plain column steps use."""
