"""Small host-side utilities of the port."""
