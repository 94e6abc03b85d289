"""Photon sources of the port (see generator/photon.py)."""
