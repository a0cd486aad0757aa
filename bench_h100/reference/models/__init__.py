"""Frozen copy of the port's ``models`` modules that the plain column steps use."""
