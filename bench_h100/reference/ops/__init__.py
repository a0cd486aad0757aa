"""Frozen copy of the port's ``ops`` modules that the plain column steps use."""
