"""Training runtime of the port (decentralized expert trainer)."""
