"""The dense decoder of the port."""
