"""Entry points of the port (the serving engine)."""
