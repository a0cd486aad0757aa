"""Frozen copy of the port's ``parameters`` modules that the plain column steps use."""
