"""Logical-axis sharding rules of the port (``rules``)."""
