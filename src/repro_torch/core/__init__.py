"""Routing core of the port (Eq. 28 centroid router)."""
